"""The chunked gated delta rule: kernel Q2.

Counterpart of :func:`colpali_tpu.models.qwen3_5.chunk_gated_delta_rule`
(HF ``torch_chunk_gated_delta_rule``, modeling_qwen3_next.py:440-517), the
token mixer of Qwen3.5's GatedDeltaNet layers. From ``query, key (B, S, Hk,
Dk)``, ``value (B, S, Hv, Dv)``, the log-decay ``g (B, S, Hv)`` (fp32, as
the JAX package computes it) and ``beta (B, S, Hv)``, with value head ``j``
reading key head ``j // (Hv / Hk)`` (JAX's ``jnp.repeat`` over the heads),
it returns ``(B, S, Hv, Dv)`` in the query's dtype. Everything runs in fp32:
q and k are l2-normalised (eps 1e-6) and q scaled by ``Dk**-0.5``, the
sequence is cut into chunks of 64 (rows past ``S`` are zero rows with ``g =
beta = 0``), and a ``(Dk, Dv)`` state per head is carried from chunk to
chunk. In a chunk with in-chunk cumulative decay ``G``:

- ``T = -(beta k k^T) * exp(G_i - G_j)`` on the strict lower triangle, the
  exponent masked before ``exp`` (the upper triangle's ``G_i - G_j`` is
  positive and overflows);
- ``v_new = (I - T)^-1 (beta v - beta e^G (k S))``;
- ``out = e^G (q S) + tril(q k^T * exp(G_i - G_j)) v_new``;
- ``S <- e^{G_last} S + (k e^{G_last - G})^T v_new``.

:func:`chunk_gated_delta_rule` launches ``csrc/gated_delta_rule.cu`` for
CUDA tensors (Dk = 128, Dv a multiple of 64; q/k/v may be strided views of
the conv's output: no transpose, pad or head repeat in device memory) and
runs :func:`chunk_gated_delta_rule_plain`, JAX's algorithm op for op, for
CPU tensors. The kernel has no backward yet: on the card a call that needs
a gradient raises (training Qwen3.5 is the next slice). On the CPU autograd
differentiates the plain version, as JAX differentiates its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu

GATED_DELTA_RULE = CudaKernel("colpali_gated_delta_rule", [*[P] * 6, *[I32] * 6, I64, I64])
CHUNK = 64
KEY_DIMS = (128,)  # the kernel's Dk; Dv a multiple of VALUE_BLOCK
VALUE_BLOCK = 64  # state columns a CTA holds


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """FLA-style l2norm (modeling_qwen3_next.py:436-439): ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _check_shapes(query, key, value, g, beta) -> None:
    b, s, hk, dk = query.shape
    if key.shape != query.shape:
        raise ValueError(f"key {tuple(key.shape)} != query {tuple(query.shape)}")
    if value.ndim != 4 or value.shape[:2] != (b, s) or value.shape[2] % hk:
        raise ValueError(f"value {tuple(value.shape)} must be (B={b}, S={s}, Hv, Dv) with Hv a multiple of {hk}")
    hv = value.shape[2]
    for name, t in (("g", g), ("beta", beta)):
        if tuple(t.shape) != (b, s, hv):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, s, hv)}")


def chunk_gated_delta_rule_plain(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, g: torch.Tensor,
                                 beta: torch.Tensor, chunk_size: int = CHUNK) -> torch.Tensor:
    """Q2's plain version: the JAX package's ``chunk_gated_delta_rule`` op
    for op (key heads repeated to the value heads, the triangular solve, the
    scan over chunks as a loop), in fp32, differentiable."""
    _check_shapes(query, key, value, g, beta)
    in_dtype = query.dtype
    b, s, hk, dk = query.shape
    h, dv = value.shape[2], value.shape[3]
    rep = h // hk
    q = l2norm(query.float())
    k = l2norm(key.float())
    if rep > 1:
        q, k = q.repeat_interleave(rep, dim=2), k.repeat_interleave(rep, dim=2)
    q, k, v = (x.transpose(1, 2) for x in (q, k, value.float()))  # (B, H, S, D)
    g, beta = g.float().transpose(1, 2), beta.float().transpose(1, 2)
    pad = (-s) % chunk_size
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        g, beta = F.pad(g, (0, pad)), F.pad(beta, (0, pad))
    total = s + pad
    n, c = total // chunk_size, chunk_size
    q = q * dk**-0.5
    v_beta = v * beta[..., None]
    k_beta = k * beta[..., None]
    q, k, v, k_beta, v_beta = (x.reshape(b, h, n, c, x.shape[-1]) for x in (q, k, v, k_beta, v_beta))
    g = torch.cumsum(g.reshape(b, h, n, c), dim=-1)
    idx = torch.arange(c, device=q.device)
    lower_incl = idx[None, :] <= idx[:, None]
    strict_lower = idx[None, :] < idx[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def decay_of(gc):  # the exponent masked before exp (see the module docstring)
        diff = torch.where(lower_incl, gc[..., :, None] - gc[..., None, :], zero)
        return torch.where(lower_incl, torch.exp(diff), zero)

    t_mat = torch.where(strict_lower, -(k_beta @ k.transpose(-1, -2)) * decay_of(g), zero)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    attn = torch.linalg.solve_triangular(eye - t_mat, eye.expand(t_mat.shape), upper=False)
    v2 = attn @ v_beta
    k_cumdecay = attn @ (k_beta * torch.exp(g)[..., None])
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(n):
        q_i, k_i, g_i = q[:, :, i], k[:, :, i], g[:, :, i]
        attn_local = torch.where(lower_incl, (q_i @ k_i.transpose(-1, -2)) * decay_of(g_i), zero)
        v_new = v2[:, :, i] - k_cumdecay[:, :, i] @ state
        outs.append((q_i * torch.exp(g_i)[..., None]) @ state + attn_local @ v_new)
        g_last = g_i[..., -1]
        state = state * torch.exp(g_last)[..., None, None] + (
            k_i * torch.exp(g_last[..., None] - g_i)[..., None]).transpose(-1, -2) @ v_new
    out = torch.stack(outs, dim=2).reshape(b, h, total, dv)[:, :, :s]
    return out.transpose(1, 2).to(in_dtype)


def _check_rows(name: str, t: torch.Tensor, heads: int, dim: int) -> int:
    """The token stride of a ``(B, S, H, D)`` view whose heads lie ``D``
    apart and whose batch rows lie ``S`` tokens apart (a slice of a wider
    row, like the conv's output, is taken as it is)."""
    b, s = t.shape[:2]
    if t.stride(3) != 1 or t.stride(2) != dim or (b > 1 and t.stride(0) != s * t.stride(1)) or \
            t.stride(1) < heads * dim:
        raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()}: the kernel reads rows of H x D "
                         "contiguous values, S rows a batch entry")
    return t.stride(1)


def chunk_gated_delta_rule(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, g: torch.Tensor,
                           beta: torch.Tensor) -> torch.Tensor:
    """The chunked gated delta rule (see the module docstring): kernel Q2
    for CUDA tensors, the plain version for CPU tensors. On the card
    ``query``, ``key``, ``value`` and ``beta`` share one dtype (bf16 or
    fp32) and ``g`` is fp32; a call whose inputs need a gradient raises."""
    if on_cpu(query):
        return chunk_gated_delta_rule_plain(query, key, value, g, beta)
    _check_shapes(query, key, value, g, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value, g, beta)):
        raise NotImplementedError("the chunked gated delta rule (Q2) has no backward kernel yet: training Qwen3.5 on "
                                  "the card is the next slice (ROADMAP.md, Queue 1 item 8.5)")
    b, s, hk, dk = query.shape
    hv, dv = value.shape[2], value.shape[3]
    dtype, dev = query.dtype, query.device
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"query has dtype {dtype}; the kernel takes bfloat16 or float32")
    if dk not in KEY_DIMS or dv % VALUE_BLOCK:
        raise ValueError(f"Dk={dk}, Dv={dv}: the kernel takes Dk in {KEY_DIMS} and Dv a multiple of {VALUE_BLOCK}")
    for name, t in (("key", key), ("value", value), ("beta", beta)):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; expected {dtype} on {dev}")
    ld_qk = _check_rows("query", query, hk, dk)
    if _check_rows("key", key, hk, dk) != ld_qk:
        raise ValueError("query and key must share their token stride")
    ld_v = _check_rows("value", value, hv, dv)
    beta = beta.contiguous()
    check_cuda("g", g, torch.float32, dev)
    check_cuda("beta", beta, dtype, dev)
    out = torch.empty((b, s, hv, dv), dtype=dtype, device=dev)
    if b and s:
        GATED_DELTA_RULE(dev, query.data_ptr(), key.data_ptr(), value.data_ptr(), g.data_ptr(), beta.data_ptr(),
                         out.data_ptr(), b, s, hk, hv, dv, int(dtype == torch.bfloat16), ld_qk, ld_v)
    return out
