"""Port parity: gradients of colpali_tpu_torch's ``flash_attention`` (on the
CPU: autograd through K6's plain version, the oracle of the backward
kernels) against ``jax.grad`` of the JAX package's einsum path masked with
``segment_bias``.

Same q, k, v, segments and output gradient from a numpy seed. Tolerance:
fp32, atol=2e-5 on gradients of order 1 (products and the softmax summed in
another order). Head dims 12 and 32 stand in for 72 (not a multiple of 16)
and 256; the Qwen2-VL family's 128 (the decoders: causal GQA 16/2 and 12/2
with left padding) and 80 (the vision towers' windows) run at their own
width, and so do the Idefics3 decoder's 64 (causal GQA 9/3 with right
padding): once with one id array, and once with the keys' own ids
(``kv_segments``: every query id 1, the keys the validity mask), held
against ``jax.grad`` of the JAX package's key-padding bias
(``make_attention_bias``), under which pad rows attend to the valid keys.
Segment ids cannot leave a row without a key (a token matches
itself, also under ``causal``); the nearest case, a token alone in its
segment, is covered: its probability is 1 and its dq is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.models import layers as jl
from colpali_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5


def jax_attention(q, k, v, seg, scale, causal, key_padding=False):
    """The einsum path of colpali_tpu's Attention: K/V heads repeated, fp32
    logits plus ``segment_bias`` (or, with ``key_padding``, the decoders'
    ``make_attention_bias`` of ``seg`` as the keys' validity mask), softmax,
    weighted sum."""
    rep = q.shape[2] // k.shape[2]
    kr, vr = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
    bias = jl.make_attention_bias(seg, causal) if key_padding else jl.segment_bias(seg, causal=causal)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, kr) * scale + bias
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), vr)


def segments(kind, b, s):
    if kind == "full":
        return np.ones((b, s), np.int32)
    if kind == "padding":
        seg = np.ones((b, s), np.int32)
        seg[1, s - 4:] = 0
        seg[b - 1, s - 9:] = 0
        return seg
    if kind == "left":  # a decoder batch: rows left-padded by 0, 4 and 9 tokens (segment 0)
        return (np.arange(s)[None] >= np.array([0, 4, 9])[:b, None]).astype(np.int32)
    if kind in ("right", "keypad"):  # the Idefics3 decoder's batch: rows right-padded by 0, 4 and 9 tokens
        return (np.arange(s)[None] < s - np.array([0, 4, 9])[:b, None]).astype(np.int32)
    if kind == "window":
        seg = (np.arange(s) // 5)[None].repeat(b, 0).astype(np.int32)
        seg[1, -3:] = -1
        return seg
    seg = np.ones((b, s), np.int32)  # "alone": one token in a segment of its own
    seg[0, 3] = 7
    seg[1, 0] = 9
    return seg


CASES = [
    # h, hkv, d, segments, causal
    (4, 4, 12, "full", False),  # SigLIP: MHA, a head dim that needs zero-filled lanes
    (8, 1, 32, "padding", False),  # Gemma: MQA over padded rows
    (4, 2, 12, "window", False),  # GQA inside windows
    (2, 2, 12, "window", True),  # causal inside windows
    (4, 1, 32, "alone", True),  # a row whose only key is itself, under a causal mask over MQA
    (16, 2, 128, "left", True),  # Qwen2.5-VL-3B's decoder: GQA 16/2, causal, left padding
    (12, 2, 128, "left", True),  # Qwen2-VL-2B's decoder: GQA 12/2
    (4, 4, 80, "window", False),  # the Qwen vision towers' windowed blocks
    (9, 3, 64, "right", True),  # colSmol-256M's decoder (GQA 9/3), right padding as one id array
    (9, 3, 64, "keypad", True),  # the same rows with kv_segments: queries id 1, keys the mask (JAX's additive bias)
]


def ids(kind, seg):
    """``(segments, kv_segments)`` of a case: under ``keypad`` every query
    takes id 1 and the keys the validity mask ``seg``."""
    return (np.ones_like(seg), seg) if kind == "keypad" else (seg, None)


@pytest.mark.parametrize("h,hkv,d,kind,causal", CASES)
def test_gradients_match_jax(h, hkv, d, kind, causal):
    rng = np.random.default_rng(h * 100 + d + causal)
    b, s = 3, 21
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    d_out = rng.normal(size=(b, s, h, d)).astype(np.float32)
    seg = segments(kind, b, s)
    scale = d**-0.5

    want = jax.jit(jax.grad(lambda *qkv: jnp.sum(jax_attention(*qkv, jnp.asarray(seg), scale, causal,
                                                               kind == "keypad") * d_out),
                            argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    q_ids, kv_ids = ids(kind, seg)
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(q_ids), scale, causal,
                             kv_segments=None if kv_ids is None else torch.from_numpy(kv_ids))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(d_out))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=f"d{name}")
    if kind == "alone":
        assert np.abs(got[0][0, 3].numpy()).max() <= ATOL  # softmax over one key: no gradient reaches q


@pytest.mark.parametrize("h,hkv,d,kind,causal", CASES)
def test_backward_plain_with_the_kernels_roundings_stays_near_the_gradient(h, hkv, d, kind, causal):
    """``flash_attention_backward_plain`` rounds P and dS to bf16 as the CUDA
    kernels do. Against autograd in fp32 on the same bf16 inputs that
    rounding alone costs up to 1.4 times the forward's rule (rtol 1.6e-2,
    atol 2% of the gradient's RMS) on these short, causal rows, where single
    terms of dS are many times the gradient's RMS; the bound is the card-only
    tests' bound of the kernels against the same oracle, 6% of the RMS."""
    g = torch.Generator().manual_seed(h + d)
    b, s = 3, 21
    q, k, v, d_out = (torch.randn((b, s, n, d), generator=g).bfloat16() for n in (h, hkv, hkv, h))
    seg, keys = (None if x is None else torch.from_numpy(x) for x in ids(kind, segments(kind, b, s)))
    got = fa.flash_attention_backward_plain(q, k, v, seg, d_out, d**-0.5, causal, kv_segments=keys)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(qf, kf, vf, seg, d**-0.5, causal, keys), (qf, kf, vf),
                               d_out.float())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        torch.testing.assert_close(a.float(), w, rtol=1.6e-2, atol=6e-2 * w.pow(2).mean().sqrt().item())


def test_backward_kernels_are_not_reached_on_the_cpu():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_backward(q, q[:, :, :1], q[:, :, :1], torch.ones(1, 4, dtype=torch.int32), q,
                                    torch.zeros(1, 2, 4), q, 1.0)
    assert fa.FLASH_ATTENTION_BWD.launches == 0
