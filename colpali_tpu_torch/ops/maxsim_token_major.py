"""Exact MaxSim over a token-major corpus: kernels K8 to K10.

Counterpart of the token-major part of :mod:`colpali_tpu.ops.maxsim_pallas`.
The corpus is ``(Np, C, D)``: doc token ``t`` of every doc, then the next
token (:func:`to_token_major` makes it from a doc-major ``(C, Np, D)``
corpus); ``C`` is a multiple of :data:`DOC_TILE`. Like the tile-major
store, it keeps one doc token of a 128-doc tile as 128 contiguous rows, so
each kernel here is its tile-major counterpart's template with the other
pair of strides, and gives its scores bit for bit on the same data:

- K8, :func:`maxsim_pallas_tm` (and :func:`maxsim_pallas`,
  :func:`maxsim_topk_tm`): bf16 queries against a bf16 corpus, K5's
  template (``csrc/maxsim_bf16.cu``);
- K9, :func:`maxsim_pallas_int8_tm`: bf16 queries against an int8 corpus
  dequantized to bf16 in the kernel, K4's template (the same file);
- K10, :func:`maxsim_pallas_int8mxu_tm`: int8 queries against the int8
  corpus, K3's template (``csrc/maxsim_int8.cu``).

Each wrapper takes its plain PyTorch version (``*_plain``: the tile-major
plain version's arithmetic, a chunk of tiles at a time) only when given CPU
tensors; for CUDA tensors it launches its kernel or raises. On the card K8
takes a bf16 corpus only: a float32 corpus is scored on the CPU route.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from colpali_tpu_torch.ops._cuda import CudaKernel, on_cpu
from colpali_tpu_torch.ops.maxsim_tiled import (  # noqa: F401  (DOC_TILE, to_token_major: re-exported)
    DOC_TILE,
    MAXSIM_BF16,
    MAXSIM_INT8,
    MAXSIM_INT8_BF16,
    _maxsim_bf16_cuda,
    _maxsim_int8_cuda,
    _tile_step,
    maxsim_int8_tiled_plain,
    maxsim_int8mxu_tiled_plain,
    maxsim_tiled_plain,
    scales_to_tile_major,
    to_tile_major,
    to_token_major,
)
from colpali_tpu_torch.utils.tensor_utils import top_k

# the tile-major entry points' arguments, with the token-major strides inside
MAXSIM_BF16_TM = CudaKernel("colpali_maxsim_bf16_tm", MAXSIM_BF16.argtypes)
MAXSIM_INT8_BF16_TM = CudaKernel("colpali_maxsim_int8_bf16_tm", MAXSIM_INT8_BF16.argtypes)
MAXSIM_INT8_TM = CudaKernel("colpali_maxsim_int8_tm", MAXSIM_INT8.argtypes)


def _check_corpus(d_query: int, docs_tm: torch.Tensor) -> Tuple[int, int]:
    """``(Np, n_tiles)`` of a token-major corpus, or the JAX package's errors."""
    np_, c, d = docs_tm.shape
    if d != d_query:
        raise ValueError(f"dim mismatch: queries {d_query} vs docs {d}")
    if c % DOC_TILE != 0:
        raise ValueError(f"num docs ({c}) must be a multiple of {DOC_TILE}")
    return np_, c // DOC_TILE


def _check_scales(scales_tm: torch.Tensor, docs_tm: torch.Tensor) -> None:
    if tuple(scales_tm.shape) != tuple(docs_tm.shape[:2]):
        raise ValueError(f"scales {tuple(scales_tm.shape)} do not match the corpus (Np, C) = "
                         f"{tuple(docs_tm.shape[:2])}")


def _by_tiles(tile_major_plain: Callable, rows: int, docs_tm: torch.Tensor, *scales_tm: torch.Tensor) -> torch.Tensor:
    """Run a tile-major plain version over the token-major corpus a chunk of
    tiles at a time (``rows``: query rows, which size the chunk)."""
    np_, c, _ = docs_tm.shape
    step = _tile_step(rows * np_ * DOC_TILE) * DOC_TILE
    return torch.cat([tile_major_plain(to_tile_major(docs_tm[:, s : s + step]),
                                       *(scales_to_tile_major(x[:, s : s + step]) for x in scales_tm))
                      for s in range(0, c, step)], dim=1)


# -- K8: bf16 ----------------------------------------------------------------------


def maxsim_pallas_tm_plain(query_embeddings: torch.Tensor, doc_embeddings_tm: torch.Tensor) -> torch.Tensor:
    """K8's plain version: K5's (:func:`maxsim_tiled_plain`: queries as
    bf16, fp32 sums) over the token-major corpus."""
    b, nq, _ = query_embeddings.shape
    return _by_tiles(lambda store: maxsim_tiled_plain(query_embeddings, store), b * nq, doc_embeddings_tm)


def maxsim_pallas_tm(query_embeddings: torch.Tensor, doc_embeddings_tm: torch.Tensor) -> torch.Tensor:
    """K8: float queries ``(B, Nq, D)`` (taken as bf16) against a
    token-major ``(Np, C, D)`` corpus -> ``(B, C)`` fp32 MaxSim scores
    (counterpart of ``maxsim_pallas_tm``). On CUDA the corpus is bf16 and
    contiguous."""
    np_, nt = _check_corpus(query_embeddings.shape[-1], doc_embeddings_tm)
    if on_cpu(doc_embeddings_tm):
        return maxsim_pallas_tm_plain(query_embeddings, doc_embeddings_tm)
    if doc_embeddings_tm.dtype != torch.bfloat16:
        raise TypeError(f"the corpus has dtype {doc_embeddings_tm.dtype}: on the card K8 takes a bfloat16 corpus "
                        "(cast it with .bfloat16(), or score a float32 corpus on the CPU route with CPU tensors)")
    return _maxsim_bf16_cuda(MAXSIM_BF16_TM, query_embeddings, doc_embeddings_tm, None, np_, nt)


def maxsim_pallas(query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor) -> torch.Tensor:
    """K8 over a doc-major ``(C, Np, D)`` corpus, made token-major on the fly
    (a copy: keep the corpus token-major and call :func:`maxsim_pallas_tm`
    on a hot path)."""
    return maxsim_pallas_tm(query_embeddings, to_token_major(doc_embeddings).contiguous())


def maxsim_topk_tm(
    query_embeddings: torch.Tensor,
    doc_embeddings_tm: torch.Tensor,
    k: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` docs per query by K8's scores -> ``(scores, int32 ids)``,
    ties toward the lower id as ``jax.lax.top_k``."""
    return top_k(maxsim_pallas_tm(query_embeddings, doc_embeddings_tm), k)


# -- K9: int8 corpus, bf16 queries ----------------------------------------------------


def maxsim_pallas_int8_tm_plain(query_embeddings: torch.Tensor, doc_embeddings_int8_tm: torch.Tensor,
                                doc_scales_tm: torch.Tensor) -> torch.Tensor:
    """K9's plain version: K4's (:func:`maxsim_int8_tiled_plain`: docs as
    ``bf16(bf16(int8) * bf16(scale))``, bf16 queries, fp32 sums) over the
    token-major corpus."""
    b, nq, _ = query_embeddings.shape
    return _by_tiles(lambda store, scales: maxsim_int8_tiled_plain(query_embeddings, store, scales), b * nq,
                     doc_embeddings_int8_tm, doc_scales_tm)


def maxsim_pallas_int8_tm(query_embeddings: torch.Tensor, doc_embeddings_int8_tm: torch.Tensor,
                          doc_scales_tm: torch.Tensor) -> torch.Tensor:
    """K9: float queries ``(B, Nq, D)`` (taken as bf16) against a token-major
    int8 corpus ``(Np, C, D)`` with ``(Np, C)`` fp32 per-token scales ->
    ``(B, C)`` fp32 scores (counterpart of ``maxsim_pallas_int8_tm``)."""
    np_, nt = _check_corpus(query_embeddings.shape[-1], doc_embeddings_int8_tm)
    _check_scales(doc_scales_tm, doc_embeddings_int8_tm)
    if on_cpu(doc_embeddings_int8_tm):
        return maxsim_pallas_int8_tm_plain(query_embeddings, doc_embeddings_int8_tm, doc_scales_tm)
    return _maxsim_bf16_cuda(MAXSIM_INT8_BF16_TM, query_embeddings, doc_embeddings_int8_tm, doc_scales_tm, np_, nt)


# -- K10: full int8 ------------------------------------------------------------------


def maxsim_pallas_int8mxu_tm_plain(query_int8: torch.Tensor, query_scales: torch.Tensor,
                                   doc_embeddings_int8_tm: torch.Tensor, doc_scales_tm: torch.Tensor) -> torch.Tensor:
    """K10's plain version: K3's (:func:`maxsim_int8mxu_tiled_plain`: exact
    int8 dot products, doc scale before the max, query scale after it) over
    the token-major corpus."""
    b, nq, _ = query_int8.shape
    return _by_tiles(lambda store, scales: maxsim_int8mxu_tiled_plain(query_int8, query_scales, store, scales),
                     b * nq, doc_embeddings_int8_tm, doc_scales_tm)


def maxsim_pallas_int8mxu_tm(query_int8: torch.Tensor, query_scales: torch.Tensor,
                             doc_embeddings_int8_tm: torch.Tensor, doc_scales_tm: torch.Tensor) -> torch.Tensor:
    """K10: int8 queries ``(B, Nq, D)`` with fp32 per-token scales ``(B, Nq)``
    (``ops.quant.quantize_per_token``) against the token-major int8 corpus
    and its ``(Np, C)`` scales -> ``(B, C)`` fp32 scores (counterpart of
    ``maxsim_pallas_int8mxu_tm``)."""
    b, nq, d = query_int8.shape
    np_, nt = _check_corpus(d, doc_embeddings_int8_tm)
    _check_scales(doc_scales_tm, doc_embeddings_int8_tm)
    if tuple(query_scales.shape) != (b, nq):
        raise ValueError(f"query_scales {tuple(query_scales.shape)} != {(b, nq)}")
    if on_cpu(doc_embeddings_int8_tm):
        return maxsim_pallas_int8mxu_tm_plain(query_int8, query_scales, doc_embeddings_int8_tm, doc_scales_tm)
    return _maxsim_int8_cuda(MAXSIM_INT8_TM, query_int8, query_scales, doc_embeddings_int8_tm, doc_scales_tm, np_, nt)
