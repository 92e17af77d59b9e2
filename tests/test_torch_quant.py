"""Port parity: colpali_tpu_torch.ops.quant against colpali_tpu.ops.quant.

Tolerance: none. int8 values, scales and packed words are compared bit for
bit; dequantized and unpacked values exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.ops import quant as jq
from colpali_tpu_torch.ops import quant as tq


def _embeddings(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 0, :] = 0.0  # an all-zero (padding) token: scale 1, valid 0
    x[..., 1, : shape[-1] // 2] = 0.0
    return x


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 4, 5, 128), (50, 16, 32)])
def test_quantize_per_token_bit_exact(shape):
    x = _embeddings(sum(shape), shape)
    qj, sj = jq.quantize_per_token(jnp.asarray(x))
    qt, st = tq.quantize_per_token(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rounds_half_to_even():
    # absmax 127 -> scale 1.0 (times fp32(1/127)*127), so x/scale lands on .5
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    qj, sj = jq.quantize_per_token(jnp.asarray(x))
    qt, st = tq.quantize_per_token(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dequantize_matches():
    x = _embeddings(1, (4, 9, 64))
    qj, sj = jq.quantize_per_token(jnp.asarray(x))
    want = np.asarray(jq.dequantize_per_token(qj, sj))
    got = tq.dequantize_per_token(torch.from_numpy(np.asarray(qj)), torch.from_numpy(np.asarray(sj)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 3, 4, 128)])
def test_binarize_words_bit_exact(shape):
    x = _embeddings(7 + len(shape), shape)
    wj, vj = jq.binarize_words(jnp.asarray(x))
    wt, vt = tq.binarize_words(torch.from_numpy(x))
    assert wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_binarize_bit31_is_negative_int32():
    x = -np.ones((1, 2, 32), np.float32)
    x[0, 0, 31] = 1.0  # only bit 31: the word is int32 min
    x[0, 1, :] = 1.0  # all 32 bits: the word is -1
    wj, _ = jq.binarize_words(jnp.asarray(x))
    wt, _ = tq.binarize_words(torch.from_numpy(x))
    assert wt[0, 0, 0].item() == -(2**31) and wt[0, 1, 0].item() == -1
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_unpack_words_roundtrip():
    x = _embeddings(3, (5, 6, 64))
    wt, _ = tq.binarize_words(torch.from_numpy(x))
    got = tq.unpack_words(wt, 64)
    want = np.asarray(jq.unpack_words(jnp.asarray(wt.numpy()), 64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy() > 0, x > 0)


def test_binarize_rejects_odd_dim():
    with pytest.raises(ValueError, match="multiple of 32"):
        tq.binarize_words(torch.zeros(2, 48))
