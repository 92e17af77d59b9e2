"""Exact MaxSim over the tile-major serving store: kernels K2 to K5.

The serving store is ``(C // DOC_TILE, Np, DOC_TILE, D)``: 128-doc tiles,
each one contiguous block (counterpart of the tile-major part of
:mod:`colpali_tpu.ops.maxsim_pallas`).

- K3, :func:`maxsim_int8mxu_tiled`: the full-int8 exact sweep over every
  doc (``csrc/maxsim_int8.cu``; replaces ``maxsim_pallas_int8mxu_tiled``).
- K2, :func:`gather_rerank_tiled`: exact fp32 MaxSim over candidate ids,
  gathered by TMA and multiplied on the bf16 tensor cores with each query
  element split into three bf16 terms, the int8 scales applied after the
  products (``csrc/gather_rerank.cu``, one template
  over the store's type; replaces ``gather_candidates_pallas`` plus the
  rerank of ``retrieval/store.py::gather_rerank``).
- K5, :func:`maxsim_tiled`, and K4, :func:`maxsim_int8_tiled`: bf16 queries
  against a bf16 store, or an int8 store dequantized to bf16 inside the
  kernel (``csrc/maxsim_bf16.cu``, one template over the store's type;
  replace ``maxsim_pallas_tiled`` and ``maxsim_pallas_int8_tiled``).

Each wrapper takes its plain PyTorch version (``*_plain``) only when given
CPU tensors; for CUDA tensors it launches its kernel or raises. The
token-major kernels K8 to K10 (:mod:`colpali_tpu_torch.ops.maxsim_token_major`)
are the K5, K4 and K3 templates with the other layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu

DOC_TILE = 128  # docs per tile == the tile-major lane axis
_PLAIN_CHUNK_ELEMS = 1 << 26  # bound on a plain version's fp32 intermediates

MAXSIM_INT8 = CudaKernel("colpali_maxsim_int8", [P, P, P, P, P, I32, I32, I32, I32, I64])
GATHER_RERANK = CudaKernel("colpali_gather_rerank", [P, P, P, P, P, I32, I32, I32, I32, I32, I64])
GATHER_RERANK_BF16 = CudaKernel("colpali_gather_rerank_bf16", [P, P, P, P, I32, I32, I32, I32, I32, I64])
MAXSIM_BF16 = CudaKernel("colpali_maxsim_bf16", [P, P, P, I32, I32, I32, I32, I64])
MAXSIM_INT8_BF16 = CudaKernel("colpali_maxsim_int8_bf16", [P, P, P, P, I32, I32, I32, I32, I64])


def to_token_major(doc_embeddings: torch.Tensor) -> torch.Tensor:
    """(C, Np, D) doc-major -> (Np, C, D) token-major (a view)."""
    return doc_embeddings.transpose(0, 1)


def to_tile_major(doc_embeddings_tm: torch.Tensor) -> torch.Tensor:
    """(Np, C, D) token-major -> (C//DOC_TILE, Np, DOC_TILE, D) tile-major."""
    np_, c, d = doc_embeddings_tm.shape
    if c % DOC_TILE != 0:
        raise ValueError(f"num docs ({c}) must be a multiple of {DOC_TILE}")
    return doc_embeddings_tm.transpose(0, 1).reshape(c // DOC_TILE, DOC_TILE, np_, d).transpose(1, 2)


def scales_to_tile_major(doc_scales_tm: torch.Tensor) -> torch.Tensor:
    """(Np, C) per-token scales -> (C//DOC_TILE, Np, DOC_TILE) tile-major."""
    np_, c = doc_scales_tm.shape
    return doc_scales_tm.T.reshape(c // DOC_TILE, DOC_TILE, np_).transpose(1, 2)


def _check_store(store: torch.Tensor, scales: Optional[torch.Tensor], d: int) -> None:
    nt, np_, t, d2 = store.shape
    if t != DOC_TILE or d2 != d:
        raise ValueError(f"store {tuple(store.shape)} does not match tile {DOC_TILE} / dim {d}")
    if scales is not None and tuple(scales.shape) != (nt, np_, t):
        raise ValueError(f"scales {tuple(scales.shape)} do not match store {tuple(store.shape)}")


def _tile_step(per_tile: int) -> int:
    return max(1, _PLAIN_CHUNK_ELEMS // max(1, per_tile))


# -- K3: full-int8 exact sweep -------------------------------------------------


def maxsim_int8mxu_tiled_plain(
    query_int8: torch.Tensor,
    query_scales: torch.Tensor,
    store: torch.Tensor,
    scales: torch.Tensor,
) -> torch.Tensor:
    """K3's plain version. The int8 x int8 dot products are taken as an fp32
    matmul: every product and partial sum is an integer below 2^24, so they
    are exact, as the kernel's int32 sums are."""
    b, nq, d = query_int8.shape
    nt, np_, t, _ = store.shape
    q2 = query_int8.reshape(b * nq, d).float()
    qs = query_scales.reshape(b * nq, 1, 1).float()
    step = _tile_step(b * nq * np_ * t)
    out = []
    for s in range(0, nt, step):
        docs = store[s : s + step].float()
        k = docs.shape[0]
        sim = (q2 @ docs.reshape(-1, d).T).reshape(b * nq, k, np_, t) * scales[s : s + step]
        out.append((sim.amax(dim=2) * qs).reshape(b, nq, k * t).sum(dim=1))
    return torch.cat(out, dim=1)


def maxsim_int8mxu_tiled(
    query_int8: torch.Tensor,
    query_scales: torch.Tensor,
    store: torch.Tensor,
    scales: torch.Tensor,
) -> torch.Tensor:
    """K3: int8 queries ``(B, Nq, D)`` with fp32 per-token scales ``(B, Nq)``
    against the int8 store and its ``(nt, Np, DOC_TILE)`` scales -> ``(B, C)``
    fp32 scores (counterpart of ``maxsim_pallas_int8mxu_tiled``)."""
    b, nq, d = query_int8.shape
    nt, np_, _, _ = store.shape
    _check_store(store, scales, d)
    if tuple(query_scales.shape) != (b, nq):
        raise ValueError(f"query_scales {tuple(query_scales.shape)} != {(b, nq)}")
    if on_cpu(store):
        return maxsim_int8mxu_tiled_plain(query_int8, query_scales, store, scales)
    return _maxsim_int8_cuda(MAXSIM_INT8, query_int8, query_scales, store, scales, np_, nt)


def _maxsim_int8_cuda(kernel: CudaKernel, query_int8: torch.Tensor, query_scales: torch.Tensor,
                      store: torch.Tensor, scales: torch.Tensor, np_: int, nt: int) -> torch.Tensor:
    """Launch K3 or K10 (``kernel``) over ``nt`` tiles of ``np_`` doc tokens.

    The kernel takes queries of a multiple of 8 tokens, at most 128: shorter
    ones are padded with zero tokens of scale 0 (they add exactly 0), longer
    ones are cut into pieces of 128 tokens whose scores are summed, since
    the sum over query tokens splits."""
    b, nq, d = query_int8.shape
    dev = store.device
    check_cuda("query_int8", query_int8, torch.int8, dev)
    check_cuda("query_scales", query_scales, torch.float32, dev)
    check_cuda("store", store, torch.int8, dev)
    check_cuda("scales", scales, torch.float32, dev)
    if d not in (64, 128, 256):
        raise ValueError(f"the int8 kernel takes dim 64, 128 or 256, got {d}")
    if b * nq * nt * np_ == 0:
        return torch.zeros((b, nt * DOC_TILE), dtype=torch.float32, device=dev)
    piece = DOC_TILE if nq > DOC_TILE else -(-nq // 8) * 8
    padded = -(-nq // piece) * piece
    if padded != nq:
        query_int8 = torch.nn.functional.pad(query_int8, (0, 0, 0, padded - nq))
        query_scales = torch.nn.functional.pad(query_scales, (0, padded - nq))
    pieces = padded // piece
    out = torch.empty((b * pieces, nt * DOC_TILE), dtype=torch.float32, device=dev)
    kernel(dev, query_int8.data_ptr(), query_scales.data_ptr(), store.data_ptr(),
           scales.data_ptr(), out.data_ptr(), b * pieces, piece, np_, d, nt)
    return out if pieces == 1 else out.reshape(b, pieces, -1).sum(dim=1)


# -- K2: fused candidate gather + exact rerank ----------------------------------

RERANK_DIMS = (64, 128, 256, 320)  # the widths K2 is built for on the card


def gather_rerank_plain(
    queries: torch.Tensor,
    store: torch.Tensor,
    scales: Optional[torch.Tensor],
    cand: torch.Tensor,
) -> torch.Tensor:
    """K2's plain version: gather the candidates' ``(Np, D)`` tokens by id,
    dequantize to fp32 (or upcast a bf16 store), MaxSim in fp32."""
    b, c = cand.shape
    _, np_, _, d = store.shape
    flat = cand.reshape(-1).long()
    tile, lane = flat // DOC_TILE, flat % DOC_TILE
    docs = store[tile, :, lane, :].float()  # (B*c, Np, D)
    if scales is not None:
        docs = docs * scales[tile, :, lane][..., None]
    sim = torch.einsum("bqd,bcnd->bqcn", queries.float(), docs.reshape(b, c, np_, d))
    return sim.amax(dim=-1).sum(dim=1)


def gather_rerank_tiled(
    queries: torch.Tensor,
    store: torch.Tensor,
    scales: Optional[torch.Tensor],
    cand: torch.Tensor,
) -> torch.Tensor:
    """K2: fp32 queries ``(B, Nq, D)``, candidate doc ids ``(B, c)`` int32
    into the tile-major store -> ``(B, c)`` exact fp32 MaxSim scores. The
    store is int8 with its ``(nt, Np, DOC_TILE)`` fp32 scales, or bf16 with
    ``scales=None``; on CUDA each launches its instance of the kernel."""
    b, nq, d = queries.shape
    nt, np_, _, _ = store.shape
    _check_store(store, scales, d)
    if cand.ndim != 2 or cand.shape[0] != b:
        raise ValueError(f"cand {tuple(cand.shape)} must be (B={b}, c)")
    if on_cpu(store):
        return gather_rerank_plain(queries, store, scales, cand)
    dev = store.device
    check_cuda("queries", queries, torch.float32, dev)
    check_cuda("store", store, torch.bfloat16 if scales is None else torch.int8, dev)
    check_cuda("cand", cand, torch.int32, dev)
    c = cand.shape[1]
    if d not in RERANK_DIMS:
        raise ValueError(f"the rerank kernel is built for dims {RERANK_DIMS}, got {d}: pass CPU tensors "
                         "for the plain version")
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b * c == 0 or nq == 0:
        return out.zero_()
    if scales is None:
        GATHER_RERANK_BF16(dev, queries.data_ptr(), store.data_ptr(), cand.data_ptr(), out.data_ptr(),
                           b, nq, c, np_, d, nt)
    else:
        check_cuda("scales", scales, torch.float32, dev)
        GATHER_RERANK(dev, queries.data_ptr(), store.data_ptr(), scales.data_ptr(),
                      cand.data_ptr(), out.data_ptr(), b, nq, c, np_, d, nt)
    return out


gather_rerank_int8 = gather_rerank_tiled  # its name from before it took a bf16 store


# -- K4 (int8 store, bf16 queries) and K5 (bf16 store) --------------------------


def maxsim_int8_tiled_plain(queries: torch.Tensor, store: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K4's plain version: docs dequantized in bf16 (the product of the bf16
    value and the bf16 scale, rounded to bf16), bf16 queries, fp32 sums."""
    b, nq, d = queries.shape
    nt, np_, t, _ = store.shape
    q2 = queries.reshape(b * nq, d).to(torch.bfloat16).float()
    step = _tile_step(b * nq * np_ * t)
    out = []
    for s in range(0, nt, step):
        docs = (store[s : s + step].to(torch.bfloat16) * scales[s : s + step, ..., None].to(torch.bfloat16)).float()
        k = docs.shape[0]
        sim = (q2 @ docs.reshape(-1, d).T).reshape(b, nq, k, np_, t)
        out.append(sim.amax(dim=3).sum(dim=1).reshape(b, k * t))
    return torch.cat(out, dim=1)


def maxsim_tiled_plain(queries: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """K5's plain version: bf16 store, bf16 queries, fp32 sums."""
    b, nq, d = queries.shape
    nt, np_, t, _ = store.shape
    q2 = queries.reshape(b * nq, d).to(torch.bfloat16).float()
    step = _tile_step(b * nq * np_ * t)
    out = []
    for s in range(0, nt, step):
        docs = store[s : s + step].float()
        k = docs.shape[0]
        sim = (q2 @ docs.reshape(-1, d).T).reshape(b, nq, k, np_, t)
        out.append(sim.amax(dim=3).sum(dim=1).reshape(b, k * t))
    return torch.cat(out, dim=1)


def _maxsim_bf16_cuda(kernel: CudaKernel, queries: torch.Tensor, store: torch.Tensor,
                      scales: Optional[torch.Tensor], np_: int, nt: int) -> torch.Tensor:
    """Launch K4, K5, K8 or K9 (``kernel``) over ``nt`` tiles of ``np_`` doc tokens."""
    b, nq, d = queries.shape
    dev = store.device
    if queries.device != dev:
        raise ValueError(f"queries are on {queries.device}, expected {dev}")
    if not queries.is_floating_point():
        raise TypeError(f"queries have dtype {queries.dtype}, expected a float type")
    if d % 16:
        raise ValueError(f"the bf16 MaxSim kernel takes a dim that is a multiple of 16, got {d}")
    check_cuda("store", store, torch.bfloat16 if scales is None else torch.int8, dev)
    q = queries.to(torch.bfloat16).contiguous()
    out = torch.empty((b, nt * DOC_TILE), dtype=torch.float32, device=dev)
    if b * nq * nt * np_ == 0:
        return out.zero_()
    if scales is None:
        kernel(dev, q.data_ptr(), store.data_ptr(), out.data_ptr(), b, nq, np_, d, nt)
    else:
        check_cuda("scales", scales, torch.float32, dev)
        kernel(dev, q.data_ptr(), store.data_ptr(), scales.data_ptr(), out.data_ptr(), b, nq, np_, d, nt)
    return out


def maxsim_int8_tiled(queries: torch.Tensor, store: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K4: float queries ``(B, Nq, D)`` (taken as bf16) against the int8 store
    and its ``(nt, Np, DOC_TILE)`` fp32 scales -> ``(B, C)`` fp32 scores
    (counterpart of ``maxsim_pallas_int8_tiled``)."""
    _check_store(store, scales, queries.shape[-1])
    if on_cpu(store):
        return maxsim_int8_tiled_plain(queries, store, scales)
    return _maxsim_bf16_cuda(MAXSIM_INT8_BF16, queries, store, scales, store.shape[1], store.shape[0])


def maxsim_tiled(queries: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """K5: float queries ``(B, Nq, D)`` (taken as bf16) against the bf16 store
    -> ``(B, C)`` fp32 scores (counterpart of ``maxsim_pallas_tiled``)."""
    _check_store(store, None, queries.shape[-1])
    if on_cpu(store):
        return maxsim_tiled_plain(queries, store)
    return _maxsim_bf16_cuda(MAXSIM_BF16, queries, store, None, store.shape[1], store.shape[0])
