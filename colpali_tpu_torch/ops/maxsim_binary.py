"""Sign-sketch MaxSim, the coarse pass of the two-tier search: kernel K1.

Counterpart of :mod:`colpali_tpu.ops.maxsim_binary`. Each token embedding is
collapsed to its sign bits; the approximate similarity of two sketches is
``D - 2 * popcount(q_bits XOR d_bits)`` (= ``dot(sign(q), sign(d))``).

Padding convention: padded doc tokens are replaced by the doc's FIRST VALID
token before packing (:func:`fill_doc_padding`), so the kernel needs no doc
mask; fully empty docs keep all-zero words and are masked by doc count
downstream. Padded query tokens are weighted out by ``query_valid``.

Layouts: corpus words ``(C//DOC_TILE, W, Np, DOC_TILE)`` int32 with
``W = D // 32``; queries ``(B, Nq, W)`` int32 plus ``(B, Nq)`` fp32 validity.

:func:`binary_maxsim_tiled` launches ``csrc/binary_maxsim.cu`` (replaces
``binary_maxsim_pallas_tiled``; the products on the single-bit tensor cores,
up to 12 words a token) for CUDA tensors and runs
:func:`binary_maxsim_tiled_plain` (the counterpart of
``binary_maxsim_xla_tiled``) for CPU tensors. Both are integer arithmetic
with exact fp32 sums, so they agree exactly.
"""

from __future__ import annotations

import torch

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu
from colpali_tpu_torch.ops.maxsim_tiled import DOC_TILE, _tile_step

BINARY_MAXSIM = CudaKernel("colpali_binary_maxsim", [P, P, P, P, I32, I32, I32, I32, I32, I64])
MAX_KERNEL_WORDS = 12  # K1 takes tokens of up to three k256 single-bit products (dim 384) on the card


def fill_doc_padding(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace padded doc-token words ``(C, Np, W)`` with the doc's first
    valid token's words (``valid``: ``(C, Np)`` fp32). Docs with no valid
    token keep row 0."""
    first_valid = torch.argmax((valid > 0).to(torch.uint8), dim=1)  # first max wins
    fill = torch.gather(words, 1, first_valid[:, None, None].expand(-1, 1, words.shape[2]))
    return torch.where(valid[..., None] > 0, words, fill)


def words_to_tile_major(words_dm: torch.Tensor) -> torch.Tensor:
    """(C, Np, W) doc-major packed words -> (C//DOC_TILE, W, Np, DOC_TILE)."""
    c, np_, w = words_dm.shape
    if c % DOC_TILE != 0:
        raise ValueError(f"num docs ({c}) must be a multiple of {DOC_TILE}")
    return words_dm.reshape(c // DOC_TILE, DOC_TILE, np_, w).permute(0, 3, 2, 1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (as int64), by SWAR on the unsigned value."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def binary_maxsim_tiled_plain(
    query_words: torch.Tensor,
    query_valid: torch.Tensor,
    doc_words_tiled: torch.Tensor,
    dim: int,
) -> torch.Tensor:
    """K1's plain version, a few tiles at a time to bound the intermediates."""
    b, nq, n_words = query_words.shape
    n_tiles, _, np_, t = doc_words_tiled.shape
    qv = query_valid.float()
    step = _tile_step(b * nq * np_ * t * 2)
    out = []
    for s in range(0, n_tiles, step):
        words = doc_words_tiled[s : s + step]  # (k, W, Np, T)
        ham = sum(
            _popcount32(query_words[:, :, w, None, None, None] ^ words[None, None, :, w])
            for w in range(n_words)
        )  # (B, Nq, k, Np, T)
        per_tok = (dim - 2 * ham).float().amax(dim=3)  # (B, Nq, k, T)
        out.append((qv[:, :, None, None] * per_tok).sum(dim=1).reshape(b, -1))
    return torch.cat(out, dim=1)


def binary_maxsim_tiled(
    query_words: torch.Tensor,
    query_valid: torch.Tensor,
    doc_words_tiled: torch.Tensor,
    dim: int,
) -> torch.Tensor:
    """K1: approximate MaxSim of packed query sketches against the packed
    tile-major corpus -> ``(B, C)`` fp32 (integer-valued) coarse scores."""
    b, nq, n_words = query_words.shape
    n_tiles, w2, np_, t = doc_words_tiled.shape
    if w2 != n_words or n_words * 32 != dim or t != DOC_TILE:
        raise ValueError(f"word-count mismatch: queries {n_words}, docs {w2}, dim {dim}, tile {t}")
    if tuple(query_valid.shape) != (b, nq):
        raise ValueError(f"query_valid {tuple(query_valid.shape)} != {(b, nq)}")
    if on_cpu(doc_words_tiled):
        return binary_maxsim_tiled_plain(query_words, query_valid, doc_words_tiled, dim)
    dev = doc_words_tiled.device
    check_cuda("query_words", query_words, torch.int32, dev)
    check_cuda("query_valid", query_valid, torch.float32, dev)
    check_cuda("doc_words_tiled", doc_words_tiled, torch.int32, dev)
    if n_words > MAX_KERNEL_WORDS:
        raise ValueError(f"the sign-sketch kernel takes up to {MAX_KERNEL_WORDS} words a token (dim "
                         f"{32 * MAX_KERNEL_WORDS}), got {n_words}: pass CPU tensors for the plain version")
    out = torch.empty((b, n_tiles * DOC_TILE), dtype=torch.float32, device=dev)
    if b * nq * n_tiles * np_ == 0:
        return out.zero_()
    BINARY_MAXSIM(dev, query_words.data_ptr(), query_valid.data_ptr(), doc_words_tiled.data_ptr(),
                  out.data_ptr(), b, nq, n_words, np_, dim, n_tiles)
    return out
