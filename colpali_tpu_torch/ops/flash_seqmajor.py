"""Seq-major segment-masked flash attention: kernel K11.

Counterpart of :func:`colpali_tpu.ops.flash_seqmajor.flash_seqmajor`. From
``q (B, S, H, D)`` and ``k, v (B, S, Hkv, D)`` with ``H % Hkv == 0``, each
query attends to the keys whose segment id matches its own (and, with
``causal``, not past itself) -> ``(B, S, H, D)``. Pad tokens take an id no
real token uses; their rows attend to each other and callers mask them.

On the TPU this kernel was written to read seq-major blocks without the
stock flash kernel's transposes, padding and GQA repeat. The port's K6
forward kernel (``csrc/flash_attention.cu``) already reads ``(B, S, H, D)``
through TMA tensor maps over its strides, picks the KV head by index and
gets zeros past S and D from the hardware, so K11 launches that kernel,
built also for K11's head dims (80 and 128 beside 72), and counts its
launches apart on :data:`FLASH_SEQMAJOR`.
It is forward only, as on the TPU. On CUDA the inputs are bf16; for CPU
tensors :func:`flash_seqmajor_plain` runs.
"""

from __future__ import annotations

import torch

from colpali_tpu_torch.ops._cuda import CudaKernel, on_cpu
from colpali_tpu_torch.ops.flash_attention import (
    FLASH_ATTENTION,
    _check_cuda_inputs,
    _check_shapes,
    _forward_cuda,
    flash_attention_plain,
)

FLASH_SEQMAJOR = CudaKernel(FLASH_ATTENTION.symbol, FLASH_ATTENTION.argtypes)  # K6's kernel, K11's count


def flash_seqmajor_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """K11's plain version: K6's (:func:`flash_attention_plain`, fp32 logits
    and softmax, attend iff segment ids match)."""
    return flash_attention_plain(q, k, v, segments, scale, causal)


def flash_seqmajor(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    scale: float,
    causal: bool = False,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """K11: flash attention over seq-major tensors -> ``(B, S, H, D)``.

    ``segments (B, S)`` of any integer type; tokens attend iff their ids
    match. ``block_q`` and ``block_k`` are the TPU kernel's tiling: they are
    accepted, so that a caller can switch the import, and must be positive,
    but change nothing here (the kernel's tiles are fixed at 64 queries by
    64 keys). On CUDA, q, k and v are bf16 with a contiguous head dim and
    ``D`` one of 72, 80, 128 and 256. Forward only: with a gradient wanted
    on CUDA it raises (K6's :func:`flash_attention` has the backward)."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block_q ({block_q}) and block_k ({block_k}) must be positive")
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    segments = segments.to(torch.int32)
    _check_shapes(q, k, v, segments)
    if on_cpu(q):
        return flash_seqmajor_plain(q, k, v, segments, scale, causal)
    segments = segments.contiguous()
    _check_cuda_inputs(q, k, v, segments)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("flash_seqmajor is forward only, as on the TPU; for a gradient call "
                         "ops.flash_attention.flash_attention")
    return _forward_cuda(q, k, v, segments, scale, causal, with_lse=False, kernel=FLASH_SEQMAJOR)[0]
