"""Segment-masked attention: kernel K6.

Counterpart of :func:`colpali_tpu.models.layers.flash_attention_padded` (the
stock Pallas TPU flash kernel) and of the einsum path of
``colpali_tpu.models.layers.Attention`` with ``segments=`` (its
``segment_bias``). From ``q (B, S, H, D)``, ``k, v (B, S, Hkv, D)`` with
``H % Hkv == 0`` and ``segments (B, S)`` int32, each query attends to the
keys of its own segment (and, with ``causal``, not past itself). A token
validity mask is a segment id: valid tokens attend to valid tokens, pad
tokens to pad tokens, and callers mask the pad rows. ``kv_segments`` gives
the keys ids of their own, as the stock TPU kernel's ``SegmentIds(q=,
kv=)`` does: ones for the queries over the validity mask for the keys is
the JAX package's key-padding bias (``make_attention_bias``), under which
pad rows attend to the valid keys.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (bf16 only; no padding or K/V repeat in device memory) and runs
:func:`flash_attention_plain` for CPU tensors. When a gradient is needed it
goes through :class:`FlashAttention`: the forward also writes each row's
log-sum-exp and the backward launches ``csrc/flash_attention_bwd.cu`` (the
counterpart of the stock TPU kernel's ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``). On the CPU autograd differentiates the plain
version, which is also the oracle for the backward kernels. The backward
kernels take every head dim of the forward and the keys' own ids.
"""

from __future__ import annotations

from typing import Optional

import torch

from colpali_tpu_torch.ops._cuda import F32, I32, I64, P, CudaKernel, check_cuda, on_cpu

FLASH_ATTENTION = CudaKernel("colpali_flash_attention", [*[P] * 7, *[I32] * 5, *[I64] * 9, F32, I32])
FLASH_ATTENTION_BWD = CudaKernel("colpali_flash_attention_bwd", [*[P] * 12, *[I32] * 5, *[I64] * 9, F32, I32])
HEAD_DIMS = (64, 72, 80, 128, 256)  # both directions: the Idefics3 towers, SigLIP, Qwen2-VL's towers (K11), Gemma
FORWARD_LAUNCHES_BY_HEAD_DIM = {d: 0 for d in HEAD_DIMS}  # K6's launches (not K11's), counted where launched
BACKWARD_LAUNCHES_BY_HEAD_DIM = {d: 0 for d in HEAD_DIMS}  # counted where the backward is launched


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segments: torch.Tensor,
                  kv_segments: Optional[torch.Tensor] = None) -> None:
    b, s, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B={b}, S={s}, Hkv, D={d})")
    if h % k.shape[2] != 0:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({k.shape[2]})")
    for name, seg in (("segments", segments), ("kv_segments", kv_segments)):
        if seg is not None and tuple(seg.shape) != (b, s):
            raise ValueError(f"{name} {tuple(seg.shape)} != {(b, s)}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
    kv_segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6's plain version, the segment-masked einsum: fp32 logits, an
    additive ``finfo(float32).min`` bias where a query's segment and a key's
    differ (or the key lies past the query, with ``causal``), fp32 softmax
    cast to the input dtype, query heads grouped over their KV head. The
    keys' ids are ``kv_segments``, else ``segments``."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    keys = segments if kv_segments is None else kv_segments
    allowed = segments[:, :, None] == keys[:, None, :]  # (B, Sq, Sk)
    if causal:
        allowed = allowed & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(allowed, zero, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits + bias[:, None, None], dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, h, d)


def flash_attention_backward_plain(q, k, v, segments, d_out, scale: float, causal: bool = False, out=None,
                                   lse=None, kv_segments=None):
    """K6's backward written out in plain PyTorch with the kernels' own
    arithmetic -> ``(dq, dk, dv)`` in q's dtype.

    Autograd through :func:`flash_attention_plain` gives the gradient of the
    attention; this gives what ``csrc/flash_attention_bwd.cu`` computes for
    it, rounding where the kernels round: fp32 logits, ``P = exp2(x - L)``
    from the forward's base-2 row log-sum-exp ``L``, ``Delta`` from the
    forward's rounded output, and ``P`` and ``dS = P * (dP - Delta)`` rounded
    to bf16 before the products ``P^T dO``, ``dS K`` and ``dS^T Q`` (they are
    tensor-core operands there). It differs from the kernels only in the
    order of the fp32 sums, so the card-only tests hold the kernels to it far
    more tightly than to the exact gradient. ``out`` and ``lse (B, H, S)``
    default to the plain forward's; ``kv_segments`` are the keys' ids, as
    in :func:`flash_attention_plain`."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qf, dof = (t.float().reshape(b, s, hkv, group, d) for t in (q, d_out))
    kf, vf = k.float(), v.float()
    keys = segments if kv_segments is None else kv_segments
    allowed = segments[:, :, None] == keys[:, None, :]
    if causal:
        allowed = allowed & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    allowed = allowed[:, None, None]  # (B, 1, 1, Sq, Sk)
    x = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * (scale * 1.4426950408889634)
    if lse is None:
        lse = torch.logsumexp(x.masked_fill(~allowed, float("-inf")) * 0.6931471805599453, dim=-1) * 1.4426950408889634
        lse = lse.reshape(b, h, s)
    if out is None:
        out = flash_attention_plain(q, k, v, segments, scale, causal, kv_segments)
    lse = lse.reshape(b, hkv, group, s)
    p = torch.where(allowed & torch.isfinite(lse)[..., None], torch.exp2(x - lse[..., None]), 0.0)
    delta = (dof * out.float().reshape(b, s, hkv, group, d)).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, S)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, s, h, d) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels read through TMA tensor maps: a 16-byte aligned base and
    strides that are multiples of 16 bytes, the head dim contiguous."""
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows "
                         f"(strides {t.stride()})")


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segments: torch.Tensor,
                       kv_segments: Optional[torch.Tensor] = None) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}; the flash kernel takes bfloat16 "
                            "(run the model in bf16 on the card)")
        _check_rows(name, t)
    check_cuda("segments", segments, torch.int32, dev)
    if kv_segments is not None:
        check_cuda("kv_segments", kv_segments, torch.int32, dev)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]}: the flash kernel is built for head dims {HEAD_DIMS}")


def _forward_cuda(q, k, v, segments, scale: float, causal: bool, with_lse: bool,
                  kernel: CudaKernel = FLASH_ATTENTION, kv_segments: Optional[torch.Tensor] = None):
    """Launch the forward kernel -> ``(out, lse | None)``; ``lse`` is
    ``(B, H, S)`` fp32, the base-2 log-sum-exp of the scaled logits.
    ``kernel`` is the launch counter (K6's, or K11's for the same kernel)."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    keys = segments if kv_segments is None else kv_segments
    if b * s * h:
        kernel(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(), keys.data_ptr(),
               out.data_ptr(), lse.data_ptr() if with_lse else None,
               b, s, h, k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               float(scale), int(causal))
        if kernel is FLASH_ATTENTION:
            FORWARD_LAUNCHES_BY_HEAD_DIM[d] += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """K6 with its backward kernels, for CUDA bf16 tensors. The forward
    saves q, k, v, the output and the row log-sum-exp; the backward
    recomputes the probabilities tile by tile and returns dq, dk and dv
    (summed over the query heads of each KV head, in a fixed order, so two
    calls agree bit for bit).

    Both directions are Hopper kernels (``csrc/hopper.cuh``): a producer
    warp fills a ring of tiles in shared memory by TMA, read through the
    tensors' own strides, and two consumer warpgroups run ``wgmma``. The
    backward's ``dkv`` kernel computes ``S^T`` and ``dP^T`` once per (key
    tile, query tile, head), over the full head dim, and ``dq`` recomputes
    ``S`` and ``dP``: seven products against the forward's two."""

    @staticmethod
    def forward(ctx, q, k, v, segments, scale, causal, kv_segments=None):
        out, lse = _forward_cuda(q, k, v, segments, scale, causal, with_lse=True, kv_segments=kv_segments)
        ctx.save_for_backward(q, k, v, segments, kv_segments, out, lse)
        ctx.scale, ctx.causal = float(scale), bool(causal)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, segments, kv_segments, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, segments, out, lse, d_out, ctx.scale, ctx.causal,
                                              kv_segments=kv_segments)
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(q, k, v, segments, out, lse, d_out, scale: float, causal: bool = False,
                             kv_segments: Optional[torch.Tensor] = None):
    """K6's backward on CUDA tensors: ``(dq, dk, dv)``, contiguous bf16,
    shaped like q, k and v. ``out`` and ``lse`` are what the forward
    returned for these inputs (with the same ``kv_segments``, the keys' ids
    where they differ from the queries'); ``d_out`` may have any strides
    (it is made contiguous). Raises for dtypes or head dims the kernels are
    not built for."""
    _check_shapes(q, k, v, segments, kv_segments)
    if on_cpu(q):
        raise ValueError("the backward kernels run on CUDA tensors; on the CPU autograd differentiates "
                         "flash_attention_plain")
    _check_cuda_inputs(q, k, v, segments, kv_segments)
    dev = q.device
    b, s, h, d = q.shape
    hkv = k.shape[2]
    d_out = d_out.contiguous()
    keys = segments if kv_segments is None else kv_segments
    for name, t, shape, dtype in (("out", out, q.shape, torch.bfloat16), ("d_out", d_out, q.shape, torch.bfloat16),
                                  ("lse", lse, (b, h, s), torch.float32)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(shape)}")
        check_cuda(name, t, dtype, dev)
    dq = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, s, hkv, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty((b, s, hkv, d), dtype=torch.bfloat16, device=dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    if b * s * h:
        FLASH_ATTENTION_BWD(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(), keys.data_ptr(),
                            out.data_ptr(), d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d, *q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], float(scale), int(causal))
        BACKWARD_LAUNCHES_BY_HEAD_DIM[d] += 1
    return dq, dk, dv


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
    kv_segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6: segment-masked attention -> ``(B, S, H, D)`` in q's dtype.

    On CUDA, q, k and v must be bf16 with the head dim contiguous (any
    batch, sequence and head strides that are multiples of 8) and ``D`` one
    of :data:`HEAD_DIMS`; ``segments`` (and ``kv_segments``, the keys' ids
    where they differ from the queries') are contiguous int32. When autograd is
    recording and an input needs a gradient, the call goes through
    :class:`FlashAttention` (the forward then also writes the log-sum-exp
    and the backward launches its kernels, never the plain version);
    otherwise the forward alone is launched, as when serving."""
    _check_shapes(q, k, v, segments, kv_segments)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, segments, scale, causal, kv_segments)
    _check_cuda_inputs(q, k, v, segments, kv_segments)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, segments, scale, causal, kv_segments)
    return _forward_cuda(q, k, v, segments, scale, causal, with_lse=False, kv_segments=kv_segments)[0]
