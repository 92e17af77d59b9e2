"""Segment-masked attention: kernel K6.

Counterpart of :func:`colpali_tpu.models.layers.flash_attention_padded` (the
stock Pallas TPU flash kernel) and of the einsum path of
``colpali_tpu.models.layers.Attention`` with ``segments=`` (its
``segment_bias``). From ``q (B, S, H, D)``, ``k, v (B, S, Hkv, D)`` with
``H % Hkv == 0`` and ``segments (B, S)`` int32, each query attends to the
keys of its own segment (and, with ``causal``, not past itself). A token
validity mask is a segment id: valid tokens attend to valid tokens, pad
tokens to pad tokens, and callers mask the pad rows.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (bf16 only; no padding or K/V repeat in device memory) and runs
:func:`flash_attention_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from colpali_tpu_torch.ops._cuda import F32, I32, I64, P, CudaKernel, check_cuda, on_cpu

FLASH_ATTENTION = CudaKernel("colpali_flash_attention", [P, P, P, P, P, *[I32] * 5, *[I64] * 9, F32, I32])
HEAD_DIMS = (72, 256)  # SigLIP's and Gemma's: the head dims the kernel is built for


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segments: torch.Tensor) -> None:
    b, s, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B={b}, S={s}, Hkv, D={d})")
    if h % k.shape[2] != 0:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({k.shape[2]})")
    if tuple(segments.shape) != (b, s):
        raise ValueError(f"segments {tuple(segments.shape)} != {(b, s)}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """K6's plain version, the segment-masked einsum: fp32 logits, an
    additive ``finfo(float32).min`` bias where segments differ (or a key lies
    past the query, with ``causal``), fp32 softmax cast to the input dtype,
    query heads grouped over their KV head."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    allowed = segments[:, :, None] == segments[:, None, :]  # (B, Sq, Sk)
    if causal:
        allowed = allowed & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(allowed, zero, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits + bias[:, None, None], dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, h, d)


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The kernel reads 16-byte vectors along the contiguous head dim."""
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows "
                         f"(strides {t.stride()})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """K6: segment-masked attention -> ``(B, S, H, D)`` in q's dtype.

    On CUDA, q, k and v must be bf16 with the head dim contiguous (any
    batch, sequence and head strides that are multiples of 8) and ``D`` one
    of :data:`HEAD_DIMS`; ``segments`` is contiguous int32."""
    _check_shapes(q, k, v, segments)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, segments, scale, causal)
    b, s, h, d = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}; the flash kernel takes bfloat16 "
                            "(run the model in bf16 on the card)")
        _check_rows(name, t)
    check_cuda("segments", segments, torch.int32, dev)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the flash kernel is built for head dims {HEAD_DIMS}")
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=dev)
    if b * s * h:
        FLASH_ATTENTION(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), segments.data_ptr(), out.data_ptr(),
                        b, s, h, k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        float(scale), int(causal))
    return out
