"""Per-token int8 quantization and sign-bit packing of embeddings.

Counterpart of :mod:`colpali_tpu.ops.quant`, bit for bit: the scale is
``absmax * fp32(1/127)``, which is what XLA compiles JAX's ``absmax / 127.0``
to; values are ``round(x / scale)`` with a true fp32 divide and round half
to even (``torch.round``); the same ``absmax > 0`` guard; the same int32
word layout for the packed signs.
"""

from __future__ import annotations

import numpy as np
import torch

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_per_token(embeddings: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per token vector.

    ``(..., D)`` float -> (int8 ``(..., D)``, fp32 scales ``(...)``) with
    ``values * scales[..., None] ~= embeddings``.
    """
    absmax = embeddings.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * _INV_127, torch.ones_like(absmax)).float()
    q = torch.round(embeddings / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_per_token(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_per_token` (fp32 output)."""
    return values.float() * scales[..., None]


def binarize_words(embeddings: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-binarize embeddings into packed int32 words + a validity mask.

    ``(..., D)`` float -> (``(..., D//32)`` int32 words, ``(...)`` fp32 valid).
    Bit ``j`` of word ``w`` is the sign (``> 0``) of component ``32w + j``;
    ``valid`` is 1.0 where the token has any nonzero component.
    """
    *lead, d = embeddings.shape
    if d % 32 != 0:
        raise ValueError("dim must be a multiple of 32 to pack sign bits")
    bits = (embeddings > 0).reshape(*lead, d // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=embeddings.device) << torch.arange(
        32, dtype=torch.int64, device=embeddings.device
    )
    words = (bits * weights).sum(dim=-1)  # in [0, 2^32): wrap bit 31 to int32's sign
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    valid = (embeddings != 0).any(dim=-1).float()
    return words, valid


def unpack_words(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Packed int32 words -> ``(..., dim)`` fp32 in {-1, +1} (the sign sketch)."""
    *lead, w = words.shape
    if w * 32 != dim:
        raise ValueError(f"{w} words hold {w*32} bits, expected dim={dim}")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    # arithmetic shift is fine: only bit 0 survives the & 1
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*lead, dim).float() * 2.0 - 1.0
