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
  kernel (``csrc/maxsim_bf16.cu``, one template over the store's type:
  TMA ring, bf16 ``wgmma`` with the queries in registers; replace
  ``maxsim_pallas_tiled`` and ``maxsim_pallas_int8_tiled``). How a call is
  cut over the card is :func:`maxsim_bf16_plan`.

Each wrapper takes its plain PyTorch version (``*_plain``) only when given
CPU tensors; for CUDA tensors it launches its kernel or raises. The
token-major kernels K8 to K10 (:mod:`colpali_tpu_torch.ops.maxsim_token_major`)
are the K5, K4 and K3 templates with the other layout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu

DOC_TILE = 128  # docs per tile == the tile-major lane axis
_PLAIN_CHUNK_ELEMS = 1 << 26  # bound on a plain version's fp32 intermediates

MAXSIM_INT8 = CudaKernel("colpali_maxsim_int8", [P, P, P, P, P, I32, I32, I32, I32, I64])
GATHER_RERANK = CudaKernel("colpali_gather_rerank", [P, P, P, P, P, I32, I32, I32, I32, I32, I64])
GATHER_RERANK_BF16 = CudaKernel("colpali_gather_rerank_bf16", [P, P, P, P, I32, I32, I32, I32, I32, I64])
# q, store, [scales,] out, scratch, b, nq, np, d, n_tiles, then the plan: qpc, pair, ctas, split
_SWEEP_ARGS = [I32, I32, I32, I32, I64, I32, I32, I32, I32]
MAXSIM_BF16 = CudaKernel("colpali_maxsim_bf16", [P, P, P, P, *_SWEEP_ARGS])
MAXSIM_INT8_BF16 = CudaKernel("colpali_maxsim_int8_bf16", [P, P, P, P, P, *_SWEEP_ARGS])


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

INT8_DIMS = (64, 128, 256, 320)  # the widths K3 (and K10) are built for on the card


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
    if d not in INT8_DIMS:
        raise ValueError(f"the int8 kernel takes dim {', '.join(map(str, INT8_DIMS))}, got {d}")
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


SWEEP_DIMS = (64, 128, 256, 320)  # the widths K4/K5 (and K8/K9) are built for on the card
SWEEP_ROWS = 64  # query rows a consumer warpgroup holds: one wgmma m64


class SweepPlan(NamedTuple):
    """How one K4/K5/K8/K9 call is cut over the card (see ``csrc/maxsim_bf16.cu``)."""

    pieces: int  # a query of more than SWEEP_ROWS tokens is cut into pieces of SWEEP_ROWS, their scores summed
    b: int  # queries of the launch: B * pieces
    nq: int  # tokens a query of the launch
    qpc: int  # whole queries a consumer's slot holds (qpc * nq <= SWEEP_ROWS rows)
    slots: int  # query slots: ceil(b / qpc)
    pair: bool  # a CTA's two consumers take two slots against all 128 docs; else one slot, half the docs each
    lanes: int  # CTAs' shares of the slots: the CTAs that read one tile's blocks
    segments: int  # (tile, lane) pairs, Np blocks each
    split: bool  # the doc tokens split across CTAs too: maxima to scratch, a second kernel sums
    ctas: int  # the grid
    k_max: int  # scratch slots of a segment: the most CTAs that share one (1 when not split)
    scratch_bytes: int


def _cta_of(pos: int, ctas: int, work: int) -> int:
    """The CTA whose range of a split run holds block ``pos`` (the kernel's ``cta_of``)."""
    return ((pos + 1) * ctas - 1) // work


def maxsim_bf16_plan(b: int, nq: int, np_: int, d: int, n_tiles: int, sms: int,
                     split_ctas: Optional[int] = None) -> SweepPlan:
    """The plan of one K4/K5/K8/K9 launch over ``n_tiles`` tiles of ``np_``
    doc tokens for ``b`` queries of ``nq`` tokens on a card of ``sms`` SMs.

    Whole queries go to a consumer's slot of up to 64 rows. At ``d <= 128``
    with two slots or more a CTA takes two slots ("pair"); otherwise one,
    its consumers halving the docs. With at least as many (tile, lane)
    segments as SMs, one CTA an SM walks whole segments; with fewer, the
    segments' blocks are cut into ``sms`` equal ranges, one a CTA, and the
    maxima go through scratch. ``split_ctas`` forces it: 0 never splits, a
    positive count splits over that many CTAs (at most one a block)."""
    pieces = 1 if nq <= SWEEP_ROWS else -(-nq // SWEEP_ROWS)
    b_eff, nq_eff = b * pieces, min(nq, SWEEP_ROWS)
    qpc = SWEEP_ROWS // nq_eff
    slots = -(-b_eff // qpc)
    pair = d <= 128 and slots >= 2
    lanes = -(-slots // 2) if pair else slots
    segments = n_tiles * lanes
    work = segments * np_
    split = segments < sms if split_ctas is None else split_ctas > 0
    if not split:
        return SweepPlan(pieces, b_eff, nq_eff, qpc, slots, pair, lanes, segments, False, min(segments, sms), 1, 0)
    ctas = min(split_ctas or sms, work)
    k_max = max(_cta_of(s * np_ + np_ - 1, ctas, work) - _cta_of(s * np_, ctas, work) + 1 for s in range(segments))
    return SweepPlan(pieces, b_eff, nq_eff, qpc, slots, pair, lanes, segments, True, ctas, k_max,
                     k_max * b_eff * nq_eff * n_tiles * DOC_TILE * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def query_pieces(q: torch.Tensor) -> torch.Tensor:
    """``(B, Nq, D)`` queries as ``(B * pieces, min(Nq, 64), D)``: a query of
    more than 64 tokens zero-padded to a multiple of 64 and cut into pieces
    (a zero token adds exactly 0, and a query's score is the sum of its
    pieces' scores)."""
    b, nq, d = q.shape
    if nq <= SWEEP_ROWS:
        return q
    pieces = -(-nq // SWEEP_ROWS)
    q = torch.nn.functional.pad(q, (0, 0, 0, pieces * SWEEP_ROWS - nq))
    return q.reshape(b * pieces, SWEEP_ROWS, d)


def _maxsim_bf16_cuda(kernel: CudaKernel, queries: torch.Tensor, store: torch.Tensor,
                      scales: Optional[torch.Tensor], np_: int, nt: int,
                      split_ctas: Optional[int] = None) -> torch.Tensor:
    """Launch K4, K5, K8 or K9 (``kernel``) over ``nt`` tiles of ``np_`` doc
    tokens by :func:`maxsim_bf16_plan` (``split_ctas`` forces its split)."""
    b, nq, d = queries.shape
    dev = store.device
    if queries.device != dev:
        raise ValueError(f"queries are on {queries.device}, expected {dev}")
    if not queries.is_floating_point():
        raise TypeError(f"queries have dtype {queries.dtype}, expected a float type")
    if d not in SWEEP_DIMS:
        raise ValueError(f"the bf16 MaxSim kernel is built for dims {SWEEP_DIMS}, got {d}: pass CPU tensors "
                         "for the plain version")
    check_cuda("store", store, torch.bfloat16 if scales is None else torch.int8, dev)
    if scales is not None:
        check_cuda("scales", scales, torch.float32, dev)
    if b * nq * nt * np_ == 0:
        return torch.zeros((b, nt * DOC_TILE), dtype=torch.float32, device=dev)
    q = query_pieces(queries.to(torch.bfloat16).contiguous())
    plan = maxsim_bf16_plan(b, nq, np_, d, nt, _sm_count(dev.index or 0), split_ctas)
    out = torch.empty((plan.b, nt * DOC_TILE), dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev) if plan.split else out
    ptrs = [q.data_ptr(), store.data_ptr(), *([] if scales is None else [scales.data_ptr()]), out.data_ptr(),
            scratch.data_ptr()]
    kernel(dev, *ptrs, plan.b, plan.nq, np_, d, nt, plan.qpc, int(plan.pair), plan.ctas, int(plan.split))
    return out if plan.pieces == 1 else out.reshape(b, plan.pieces, -1).sum(dim=1)


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
