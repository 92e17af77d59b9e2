"""Port parity: K6's plain version (colpali_tpu_torch.ops.flash_attention),
through the port's ``Attention``, against colpali_tpu's ``Attention`` on its
einsum path (``use_flash=False``), which masks with ``segment_bias`` for
``segments=`` and with ``make_attention_bias`` for ``mask=``.

Both modules get the same projection weights; inputs come from numpy seeds.
Tolerance: fp32 atol=1e-5 (fp32 products and softmax summed in another
order); bf16 atol=2e-2 (bf16 projections and probabilities, rounded at other
places, on outputs of order 1). With ``mask=``, pad query rows attend to
pad keys in the port and to valid keys in JAX: only valid rows are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.models import layers as jl
from colpali_tpu_torch.models import layers as tl
from colpali_tpu_torch.ops import flash_attention as fa

HIDDEN = 32


def _pair(heads, kv_heads, head_dim, use_bias, dtype, seed=0):
    jmod = jl.Attention(num_heads=heads, head_dim=head_dim, num_kv_heads=kv_heads, use_bias=use_bias,
                        use_flash=False, dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    x = jnp.zeros((1, 4, HIDDEN), jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), x, segments=jnp.ones((1, 4), jnp.int32))["params"]
    if use_bias:  # flax initializes biases to zero: give them values
        rng = np.random.default_rng(seed)
        params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim == 1 else a,
                              params)
    tmod = tl.Attention(HIDDEN, heads, head_dim, num_kv_heads=kv_heads, use_bias=use_bias, device="cpu",
                        dtype=dtype)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin = getattr(tmod, name)
            lin.weight.copy_(torch.tensor(np.asarray(params[name]["kernel"], np.float32).T))
            if use_bias:
                lin.bias.copy_(torch.tensor(np.asarray(params[name]["bias"], np.float32)))
    return jmod, {"params": params}, tmod


def _segments(kind, b, s, rng):
    if kind == "full":
        return np.ones((b, s), np.int32)
    if kind == "window":  # Qwen2.5-vision style window ids, -1 padding on row 1
        seg = (np.arange(s) // 5)[None].repeat(b, 0).astype(np.int32)
        seg[1, -3:] = -1
        return seg
    mask = np.ones((b, s), np.int32)  # key padding, right-padded rows
    mask[1, s - 4 :] = 0
    mask[2 % b, s - 7 :] = 0
    return mask


CASES = [
    # heads, kv_heads, head_dim, use_bias, segments, causal, rope
    (4, 4, 16, True, "full", False, False),  # SigLIP: MHA with biases, no mask
    (4, 1, 16, False, "padding", False, True),  # Gemma: MQA, rope, key padding
    (4, 2, 8, False, "window", False, False),  # GQA with window segment ids
    (4, 1, 16, False, "padding", True, True),  # causal over padded rows
    (2, 2, 24, True, "window", True, False),  # causal inside windows
]


@pytest.mark.parametrize("heads,kv_heads,head_dim,use_bias,kind,causal,rope", CASES)
def test_attention_matches_jax_einsum(heads, kv_heads, head_dim, use_bias, kind, causal, rope):
    rng = np.random.default_rng(heads * 100 + head_dim)
    b, s = 3, 21
    jmod, variables, tmod = _pair(heads, kv_heads, head_dim, use_bias, torch.float32)
    x = rng.normal(size=(b, s, HIDDEN)).astype(np.float32)
    seg = _segments(kind, b, s, rng)
    kw_j, kw_t = {"causal": causal}, {"causal": causal}
    if rope:
        pos = np.arange(1, s + 1)[None].repeat(b, 0)
        kw_j["rope"] = jl.rope_cos_sin(jnp.asarray(pos), head_dim, 10000.0)
        kw_t["rope"] = tl.rope_cos_sin(torch.from_numpy(pos), head_dim, 10000.0)
    key = "mask" if kind == "padding" else "segments"
    kw_j[key], kw_t[key] = jnp.asarray(seg), torch.from_numpy(seg)
    want = np.asarray(jax.jit(jmod.apply, static_argnames="causal")(variables, jnp.asarray(x), **kw_j))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), **kw_t).numpy()
    rows = seg > 0 if kind == "padding" else np.ones_like(seg, bool)
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5)


def test_attention_bf16_matches_jax_einsum():
    rng = np.random.default_rng(7)
    jmod, variables, tmod = _pair(4, 1, 16, False, torch.bfloat16)
    x = rng.normal(size=(2, 19, HIDDEN)).astype(np.float32)
    seg = np.ones((2, 19), np.int32)
    seg[1, 15:] = 0
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x, jnp.bfloat16), mask=jnp.asarray(seg)), np.float32)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(torch.bfloat16), mask=torch.from_numpy(seg)).float().numpy()
    np.testing.assert_allclose(got[seg > 0], want[seg > 0], atol=2e-2)


def test_plain_matches_segment_bias_einsum():
    """flash_attention_plain on its own against the JAX einsum written out
    with ``segment_bias`` (MQA, causal)."""
    rng = np.random.default_rng(3)
    b, s, h, hkv, d = 2, 13, 4, 1, 8
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    seg = np.array([[1] * 9 + [0] * 4, [2] * 6 + [3] * 7], np.int32)
    bias = np.asarray(jl.segment_bias(jnp.asarray(seg), causal=True))  # (B, 1, S, S)
    kr = np.repeat(k, h // hkv, axis=2)
    vr = np.repeat(v, h // hkv, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", q, kr) * d**-0.5 + bias
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = np.einsum("bhqk,bkhd->bqhd", probs, vr)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, seg)), d**-0.5, causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_wrapper_checks_shapes():
    q = torch.zeros(2, 5, 4, 8)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention(q, torch.zeros(2, 5, 3, 8), torch.zeros(2, 5, 3, 8), torch.ones(2, 5), 1.0)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention(q, torch.zeros(2, 6, 1, 8), torch.zeros(2, 6, 1, 8), torch.ones(2, 5), 1.0)
    with pytest.raises(ValueError, match="segments"):
        fa.flash_attention(q, torch.zeros(2, 5, 1, 8), torch.zeros(2, 5, 1, 8), torch.ones(2, 4), 1.0)
