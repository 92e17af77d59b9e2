"""Port parity: the K1 plain version (colpali_tpu_torch.ops.maxsim_binary)
against colpali_tpu's Pallas kernel in interpret mode and its XLA version.

Tolerance: none. The coarse scores are sums of small integers in fp32, so
they must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.ops import maxsim_binary as jb
from colpali_tpu.ops import quant as jq
from colpali_tpu_torch.ops import maxsim_binary as tb
from colpali_tpu_torch.ops import quant as tq

DIM = 64


def _case(seed: int, b: int, nq: int, n_tiles: int, np_: int):
    rng = np.random.default_rng(seed)
    w = DIM // 32
    qw = rng.integers(-(2**31), 2**31, size=(b, nq, w), dtype=np.int64).astype(np.int32)
    qv = (rng.random((b, nq)) > 0.25).astype(np.float32)
    dw = rng.integers(-(2**31), 2**31, size=(n_tiles, w, np_, 128), dtype=np.int64).astype(np.int32)
    return qw, qv, dw


@pytest.mark.parametrize("b,nq,n_tiles,np_", [(1, 8, 2, 4), (2, 5, 3, 16)])
def test_plain_equals_pallas_interpret_and_xla(b, nq, n_tiles, np_):
    qw, qv, dw = _case(b * 100 + nq, b, nq, n_tiles, np_)
    got = tb.binary_maxsim_tiled(torch.from_numpy(qw), torch.from_numpy(qv), torch.from_numpy(dw), DIM)
    pallas = jb.binary_maxsim_pallas_tiled(jnp.asarray(qw), jnp.asarray(qv), jnp.asarray(dw), DIM, interpret=True)
    xla = jb.binary_maxsim_xla_tiled(jnp.asarray(qw), jnp.asarray(qv), jnp.asarray(dw), DIM)
    assert got.shape == (b, n_tiles * 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def test_plain_chunking_does_not_change_scores(monkeypatch):
    qw, qv, dw = _case(5, 2, 4, 4, 8)
    args = (torch.from_numpy(qw), torch.from_numpy(qv), torch.from_numpy(dw), DIM)
    whole = tb.binary_maxsim_tiled_plain(*args)
    monkeypatch.setattr(tb, "_tile_step", lambda per_tile: 1)
    np.testing.assert_array_equal(tb.binary_maxsim_tiled_plain(*args).numpy(), whole.numpy())


def test_fill_doc_padding_left_padded_docs():
    """Left-padded docs take their FIRST VALID token's words, not token 0's."""
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(6, 8, DIM)).astype(np.float32)
    for i, n_pad in enumerate([0, 1, 3, 7, 8, 2]):
        docs[i, :n_pad] = 0.0  # left padding; doc 4 is fully empty
    docs[5, 6:] = 0.0  # and right padding on one
    wj, vj = jq.binarize_words(jnp.asarray(docs))
    want = np.asarray(jb.fill_doc_padding(wj, vj))
    wt, vt = tq.binarize_words(torch.from_numpy(docs))
    got = tb.fill_doc_padding(wt, vt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, 0], wt[2, 3].numpy())  # first valid is token 3
    assert (got[4] == 0).all()  # empty doc stays all-zero


def test_words_to_tile_major_matches():
    rng = np.random.default_rng(1)
    words = rng.integers(-(2**31), 2**31, size=(256, 5, 2), dtype=np.int64).astype(np.int32)
    want = np.asarray(jb.words_to_tile_major(jnp.asarray(words)))
    got = tb.words_to_tile_major(torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple of 128"):
        tb.words_to_tile_major(torch.from_numpy(words[:100]))


def test_wrapper_checks_shapes():
    qw, qv, dw = _case(2, 1, 4, 1, 4)
    with pytest.raises(ValueError, match="word-count"):
        tb.binary_maxsim_tiled(torch.from_numpy(qw), torch.from_numpy(qv), torch.from_numpy(dw), 2 * DIM)
    with pytest.raises(ValueError, match="query_valid"):
        tb.binary_maxsim_tiled(torch.from_numpy(qw), torch.from_numpy(qv[:, :2]), torch.from_numpy(dw), DIM)


@pytest.mark.parametrize("np_", [260, 1040])  # a full page (1,040 tokens) pooled by 4, and unpooled
def test_plain_equals_xla_at_full_page(np_):
    """256 docs of full-page sketches: the length at which the card kernel
    streams its doc tokens in chunks."""
    qw, qv, dw = _case(np_, 2, 16, 2, np_)
    got = tb.binary_maxsim_tiled(torch.from_numpy(qw), torch.from_numpy(qv), torch.from_numpy(dw), DIM)
    want = jb.binary_maxsim_xla_tiled(jnp.asarray(qw), jnp.asarray(qv), jnp.asarray(dw), DIM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
