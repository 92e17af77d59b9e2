"""Port parity: the plain versions of K8, K9 and K10 in
colpali_tpu_torch.ops.maxsim_token_major against colpali_tpu's token-major
Pallas kernels in interpret mode.

Tolerance: the inputs are rounded to bf16 first, so every product is exact
in fp32 on both sides and only the order of the fp32 sums differs: rtol=1e-5,
atol=1e-4. K10's int8 values and scales come from each package's own
``quantize_per_token`` and must be bit-equal. The cases of
tests/ops/test_maxsim_pallas.py are repeated at that file's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.ops import maxsim_pallas as jp
from colpali_tpu.ops import quant as jq
from colpali_tpu.ops.maxsim import maxsim as jax_maxsim
from colpali_tpu_torch.ops import maxsim_tiled as tt
from colpali_tpu_torch.ops import maxsim_token_major as tm
from colpali_tpu_torch.ops.quant import quantize_per_token

RTOL, ATOL = 1e-5, 1e-4


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 and back to fp32 (values JAX and the port share exactly)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _queries(seed: int, b: int, nq: int, d: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(b, nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, -2:] = 0.0  # padded query tokens
    return q


@pytest.fixture(scope="module")
def corpus():
    """A token-major (Np=8, C=256, D=64) corpus: fp32 rounded to bf16, and
    its int8 quantization with (Np, C) scales from JAX."""
    docs = np.random.default_rng(0).normal(size=(256, 8, 64)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    docs[:, -3:] = 0.0  # zero-padded doc tokens
    docs_tm = _bf16(np.ascontiguousarray(docs.transpose(1, 0, 2)))
    d_int8, scales = jq.quantize_per_token(jnp.asarray(docs_tm))
    return docs_tm, np.array(d_int8), np.array(scales)


def test_k8_plain_matches_pallas_interpret(corpus):
    docs_tm, _, _ = corpus
    q = _bf16(_queries(1, 2, 6, 64))
    want = np.asarray(jp.maxsim_pallas_tm(jnp.asarray(q, jnp.bfloat16), jnp.asarray(docs_tm, jnp.bfloat16),
                                          interpret=True))
    got = tm.maxsim_pallas_tm(torch.from_numpy(q), torch.from_numpy(docs_tm).to(torch.bfloat16))
    assert got.shape == (2, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k9_plain_matches_pallas_interpret(corpus):
    _, d_int8, scales = corpus
    q = _bf16(_queries(2, 3, 5, 64))
    want = np.asarray(jp.maxsim_pallas_int8_tm(jnp.asarray(q), jnp.asarray(d_int8), jnp.asarray(scales),
                                               interpret=True))
    got = tm.maxsim_pallas_int8_tm(torch.from_numpy(q), torch.from_numpy(d_int8), torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k10_plain_matches_pallas_interpret(corpus):
    _, d_int8, scales = corpus
    q = _queries(3, 2, 6, 64)
    qi_j, qs_j = jq.quantize_per_token(jnp.asarray(q))
    qi, qs = quantize_per_token(torch.from_numpy(q))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_j))
    want = np.asarray(jp.maxsim_pallas_int8mxu_tm(qi_j, qs_j, jnp.asarray(d_int8), jnp.asarray(scales),
                                                  interpret=True))
    got = tm.maxsim_pallas_int8mxu_tm(qi, qs, torch.from_numpy(d_int8), torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_token_major_equals_tile_major(corpus):
    """Each token-major function gives its tile-major counterpart's scores
    on the same data (the plain versions share the arithmetic)."""
    docs_tm, d_int8, scales = (torch.from_numpy(x) for x in corpus)
    q = torch.from_numpy(_queries(4, 2, 7, 64))
    qi, qs = quantize_per_token(q)
    bf16 = docs_tm.to(torch.bfloat16)
    pairs = [
        (tm.maxsim_pallas_tm(q, bf16), tt.maxsim_tiled(q, tt.to_tile_major(bf16))),
        (tm.maxsim_pallas_int8_tm(q, d_int8, scales),
         tt.maxsim_int8_tiled(q, tt.to_tile_major(d_int8), tt.scales_to_tile_major(scales))),
        (tm.maxsim_pallas_int8mxu_tm(qi, qs, d_int8, scales),
         tt.maxsim_int8mxu_tiled(qi, qs, tt.to_tile_major(d_int8), tt.scales_to_tile_major(scales))),
    ]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_chunks_of_tiles_agree(corpus, monkeypatch):
    """A corpus scored a tile at a time agrees with one pass (int8 products
    are exact, so K10 is bit-equal; K8 sums in fp32 in another order)."""
    docs_tm, d_int8, scales = (torch.from_numpy(x) for x in corpus)
    q = torch.from_numpy(_queries(5, 2, 4, 64))
    qi, qs = quantize_per_token(q)
    whole = (tm.maxsim_pallas_int8mxu_tm(qi, qs, d_int8, scales), tm.maxsim_pallas_tm(q, docs_tm))
    monkeypatch.setattr(tm, "_tile_step", lambda per_tile: 1)
    torch.testing.assert_close(tm.maxsim_pallas_int8mxu_tm(qi, qs, d_int8, scales), whole[0], rtol=0, atol=0)
    torch.testing.assert_close(tm.maxsim_pallas_tm(q, docs_tm), whole[1], rtol=RTOL, atol=ATOL)


# -- the cases of tests/ops/test_maxsim_pallas.py, at its tolerances ----------------------


@pytest.mark.parametrize("b,c,np_", [(4, 256, 32), (1, 128, 16)], ids=["batch", "single_query"])
def test_maxsim_pallas_matches_xla_reference(b, c, np_):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, 16, 128)).astype(np.float32)
    docs = rng.normal(size=(c, np_, 128)).astype(np.float32)
    expected = np.asarray(jax_maxsim(jnp.asarray(q), jnp.asarray(docs)))
    got = tm.maxsim_pallas(torch.from_numpy(q), torch.from_numpy(docs))
    np.testing.assert_allclose(got.numpy(), expected, rtol=3e-3, atol=3e-3)


def test_topk_returns_the_best_docs():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 16, 128)).astype(np.float32)
    docs = rng.normal(size=(256, 16, 128)).astype(np.float32)
    scores, idx = tm.maxsim_topk_tm(torch.from_numpy(q), tm.to_token_major(torch.from_numpy(docs)), k=5)
    full = np.asarray(jax_maxsim(jnp.asarray(q), jnp.asarray(docs)))
    np.testing.assert_array_equal(idx.numpy(), np.argsort(-full, axis=1)[:, :5])
    assert idx.dtype == torch.int32 and scores.shape == (2, 5)
    _, jax_idx = jp.maxsim_topk_tm(jnp.asarray(q), jp.to_token_major(jnp.asarray(docs)), k=5, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_idx))


def test_non_multiple_of_tile_raises():
    q = torch.zeros((1, 16, 128))
    with pytest.raises(ValueError, match="multiple of"):
        tm.maxsim_pallas(q, torch.zeros((100, 16, 128)))
    with pytest.raises(ValueError, match="multiple of"):
        tm.maxsim_pallas_int8_tm(q, torch.zeros((16, 100, 128), dtype=torch.int8), torch.ones((16, 100)))
    with pytest.raises(ValueError, match="dim mismatch"):
        tm.maxsim_pallas_tm(q, torch.zeros((16, 128, 64)))
    with pytest.raises(ValueError, match="scales"):
        tm.maxsim_pallas_int8_tm(q, torch.zeros((16, 128, 128), dtype=torch.int8), torch.ones((128, 16)))


@pytest.mark.parametrize("full_int8", [False, True], ids=["int8", "int8_mxu"])
def test_int8_close_to_fp(full_int8):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 16, 128)).astype(np.float32)
    docs = rng.normal(size=(128, 16, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    d_int8, d_scales = quantize_per_token(torch.from_numpy(docs))
    docs_tm, scales_tm = tm.to_token_major(d_int8), d_scales.T
    if full_int8:
        got = tm.maxsim_pallas_int8mxu_tm(*quantize_per_token(torch.from_numpy(q)), docs_tm, scales_tm)
    else:
        got = tm.maxsim_pallas_int8_tm(torch.from_numpy(q), docs_tm, scales_tm)
    expected = np.asarray(jax_maxsim(jnp.asarray(q), jnp.asarray(docs)))
    # int8 quantization error on unit vectors is ~1/127 per component
    np.testing.assert_allclose(got.numpy(), expected, rtol=0.05, atol=0.3 if full_int8 else 0.2)
