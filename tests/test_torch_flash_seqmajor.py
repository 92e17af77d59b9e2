"""Port parity: K11's plain version (colpali_tpu_torch.ops.flash_seqmajor
on CPU tensors) against colpali_tpu's seq-major Pallas flash kernel in
interpret mode, on the same fp32 inputs.

Tolerance: rtol=2e-4, atol=2e-5 on the rows of valid tokens, that of
tests/ops/test_flash_seqmajor.py against its dense oracle: both sides
compute fp32 logits and an fp32 softmax, the kernel online over key blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.ops.flash_seqmajor import flash_seqmajor as jax_flash_seqmajor
from colpali_tpu_torch.ops.flash_seqmajor import flash_seqmajor

RTOL, ATOL = 2e-4, 2e-5

CASES = [
    # b, s, h, hkv, d, causal, right pad, block_q, block_k
    (2, 64, 2, 2, 72, False, 0, 512, 512),
    (2, 64, 2, 2, 80, False, 0, 512, 512),
    (2, 64, 2, 2, 128, False, 0, 512, 512),
    (1, 96, 4, 2, 128, False, 0, 32, 32),  # GQA 4/2, several q and kv blocks
    (1, 200, 2, 2, 80, True, 0, 64, 64),  # causal
    (2, 70, 2, 2, 72, False, 10, 512, 512),  # right padding in its own segment
    (1, 100, 4, 2, 80, True, 9, 32, 32),  # causal, GQA and padding together
    (1, 300, 2, 2, 80, False, 0, 128, 128),  # ragged last q and kv blocks
]


@pytest.mark.parametrize("b,s,h,hkv,d,causal,pad,block_q,block_k", CASES)
def test_plain_matches_pallas_interpret(b, s, h, hkv, d, causal, pad, block_q, block_k):
    rng = np.random.default_rng(s + d)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32) for _ in range(2))
    seg = np.ones((b, s), np.int32)
    if pad:
        seg[0, s - pad :] = 0  # pad tokens: an id no real token uses
    scale = d**-0.5
    want = np.asarray(jax_flash_seqmajor(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), scale,
                                         causal=causal, block_q=block_q, block_k=block_k, interpret=True))
    got = flash_seqmajor(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(seg), scale,
                         causal=causal, block_q=block_q, block_k=block_k)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    valid = seg.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=RTOL, atol=ATOL)


def test_rejects_what_jax_rejects():
    q, k = torch.zeros((1, 8, 6, 32)), torch.zeros((1, 8, 4, 32))
    seg = torch.ones((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        flash_seqmajor(q, k, k, seg, 0.1)
    with pytest.raises(ValueError, match="positive"):
        flash_seqmajor(q, q, q, seg, 0.1, block_q=0)
    out = flash_seqmajor(q, q, q, seg, 0.1, block_q=8, block_k=8)  # int64 segments are taken, as in JAX
    assert out.shape == q.shape
