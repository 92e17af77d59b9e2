"""Device-resident MaxSim corpus index (PyTorch counterpart of
:mod:`colpali_tpu.retrieval.store`).

The corpus lives on ``device`` in the tile-major layout
``(C//DOC_TILE, Np, DOC_TILE, D)``, int8 with per-token fp32 scales (or
bf16). :meth:`CorpusIndex.search` scores it with the exact full-int8 sweep
(kernel K3) or, on an index built with ``prefilter="binary"``, with the
two-tier search: the packed sign-sketch coarse pass (K1), a top-``c``
shortlist, then the fused candidate gather and exact rerank (K2). An int8
index with ``quantize_queries=False`` is swept by K4 and a bf16 index by K5.
On a CPU device every kernel runs as its plain PyTorch version.
:class:`DeviceIndexBuilder` packs model outputs into an index where they
lie.

The ``.npz`` written by :meth:`CorpusIndex.save` is the same format the JAX
package writes (bf16 stored as a ``uint16`` view), so either package loads
an index saved by the other.

Top-k follows ``jax.lax.top_k``: descending, and among equal scores the
lower index first (the coarse scores are integers, so ties are common).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.ops.maxsim_binary import binary_maxsim_tiled, fill_doc_padding, words_to_tile_major
from colpali_tpu_torch.ops.maxsim_tiled import (
    DOC_TILE,
    gather_rerank_tiled,
    maxsim_int8_tiled,
    maxsim_int8mxu_tiled,
    maxsim_tiled,
)
from colpali_tpu_torch.ops.quant import binarize_words, quantize_per_token
from colpali_tpu_torch.utils.tensor_utils import pad_sequences, round_up, top_k

ArrayLike = Union[np.ndarray, Sequence[np.ndarray]]
Device = Union[str, torch.device]


def gather_rerank(
    queries: torch.Tensor,
    store: torch.Tensor,
    scales: Optional[torch.Tensor],
    cand: torch.Tensor,
) -> torch.Tensor:
    """Exact MaxSim over candidate docs of a tile-major store.

    queries ``(B, Nq, D)`` fp32; store ``(nt, Np, DOC_TILE, D)`` int8 (+
    ``(nt, Np, DOC_TILE)`` fp32 scales) or bf16; cand ``(B, c)`` int32 doc
    ids. Returns ``(B, c)`` fp32 scores through the fused kernel K2."""
    return gather_rerank_tiled(queries.float().contiguous(), store, scales, cand.contiguous())


class CorpusIndex:
    """MaxSim index over a fixed document corpus.

    Args:
        doc_embeddings: ragged list of ``(len_i, dim)`` arrays (or a padded
            3D array) of L2-normalized doc token embeddings.
        dtype: storage dtype, ``"bf16"`` or ``"int8"`` (per-token symmetric
            quantization).
        doc_tokens: pad every doc to this many tokens (default: the longest
            doc, rounded up to a multiple of 16). Shorter than the longest
            doc is an error unless ``truncate=True``.
        device: where the index lives and is scored (the card unless the
            caller asks for the CPU).
        quantize_queries: int8 indexes score int8-quantized queries (kernel
            K3); False keeps bf16 queries (kernel K4). A bf16 index is
            scored by kernel K5.
        truncate: opt in to dropping tokens beyond ``doc_tokens``.
        prefilter: ``"binary"`` also stores packed sign bits and makes
            :meth:`search` two-tier.
        coarse_pool: build the sign sketch from sums of ``coarse_pool``
            contiguous doc tokens (needs ``prefilter="binary"``).

    The fp32 corpus is packed ``_BUILD_CHUNK_DOCS`` docs at a time on the
    host into int8/bf16 arrays, byte-identical to the JAX package's
    ``CorpusIndex._pack_host``, then copied to ``device``.
    """

    _BUILD_CHUNK_DOCS = 64 * DOC_TILE

    def __init__(
        self,
        doc_embeddings: ArrayLike,
        dtype: str = "bf16",
        doc_tokens: Optional[int] = None,
        device: Device = "cuda",
        quantize_queries: bool = True,
        truncate: bool = False,
        prefilter: Optional[str] = None,
        coarse_pool: int = 1,
    ):
        self._init_common(dtype, device, quantize_queries, prefilter, coarse_pool)
        if isinstance(doc_embeddings, (list, tuple)):
            docs_list = [np.asarray(d, dtype=np.float32) for d in doc_embeddings]
        else:
            docs_list = list(np.asarray(doc_embeddings, dtype=np.float32))
        if not docs_list:
            raise ValueError("No documents provided")
        self.num_docs = len(docs_list)
        self.dim = docs_list[0].shape[-1]

        max_len = max(d.shape[0] for d in docs_list)
        target_tokens = doc_tokens or max_len
        if target_tokens < max_len:
            if not truncate:
                raise ValueError(
                    f"doc_tokens={target_tokens} would truncate documents up to "
                    f"{max_len} tokens long; pool the corpus upstream or pass truncate=True"
                )
            docs_list = [d[:target_tokens] for d in docs_list]
        self.doc_tokens = round_up(target_tokens, 16)
        if self.prefilter == "binary" and self.dim % 32 != 0:
            raise ValueError(f"binary prefilter needs dim % 32 == 0, got {self.dim}")
        if self.doc_tokens % self.coarse_pool != 0:
            raise ValueError(f"coarse_pool={self.coarse_pool} must divide doc_tokens={self.doc_tokens}")
        self.padded_docs = round_up(self.num_docs, DOC_TILE)
        self._put_store(*self._pack_host(docs_list))

    def _init_common(self, dtype, device, quantize_queries, prefilter=None, coarse_pool=1) -> None:
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"Unsupported index dtype: {dtype}")
        if prefilter not in (None, "binary"):
            raise ValueError(f"Unsupported prefilter: {prefilter!r} (None or 'binary')")
        if coarse_pool < 1:
            raise ValueError(f"coarse_pool must be >= 1, got {coarse_pool}")
        if coarse_pool > 1 and prefilter != "binary":
            raise ValueError("coarse_pool > 1 requires prefilter='binary'")
        self.dtype = dtype
        self.device = torch.device(device)
        self.quantize_queries = quantize_queries
        self.prefilter = prefilter
        self.coarse_pool = coarse_pool
        self._scales: Optional[torch.Tensor] = None
        self._bwords: Optional[torch.Tensor] = None
        # two-tier shortlist size when search(candidates=None); set directly
        # or by tune_candidates()
        self.default_candidates: Optional[int] = None

    def _pack_host(self, docs_list, n_tiles: Optional[int] = None):
        """Pack ragged fp32 docs into the tile-major host arrays
        ``(store, scales | None, bwords | None)`` as torch CPU tensors, one
        chunk of tiles at a time (the same numpy arithmetic as JAX)."""
        n_tiles = n_tiles if n_tiles is not None else self.padded_docs // DOC_TILE
        np_, d = self.doc_tokens, self.dim
        if self.dtype == "int8":
            store_host = torch.zeros((n_tiles, np_, DOC_TILE, d), dtype=torch.int8)
            scales_host = torch.ones((n_tiles, np_, DOC_TILE), dtype=torch.float32)
        else:
            store_host = torch.zeros((n_tiles, np_, DOC_TILE, d), dtype=torch.bfloat16)
            scales_host = None
        bwords_host = None
        if self.prefilter == "binary":
            bwords_host = torch.zeros((n_tiles, d // 32, np_ // self.coarse_pool, DOC_TILE), dtype=torch.int32)

        chunk = self._BUILD_CHUNK_DOCS  # a whole number of tiles
        for start in range(0, len(docs_list), chunk):
            padded = pad_sequences(docs_list[start : start + chunk], pad_to=np_)  # (c, Np, D) fp32
            c = padded.shape[0]
            if c % DOC_TILE != 0:  # last chunk: pad up to the tile boundary
                padded = np.concatenate([padded, np.zeros((round_up(c, DOC_TILE) - c, np_, d), np.float32)])
            tiled = padded.reshape(-1, DOC_TILE, np_, d).transpose(0, 2, 1, 3)
            t0 = start // DOC_TILE
            t1 = t0 + tiled.shape[0]
            if self.dtype == "int8":
                absmax = np.max(np.abs(tiled), axis=-1)
                scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
                store_host[t0:t1] = torch.from_numpy(np.round(tiled / scale[..., None]).astype(np.int8))
                scales_host[t0:t1] = torch.from_numpy(scale)
            else:
                store_host[t0:t1] = torch.from_numpy(np.ascontiguousarray(tiled)).to(torch.bfloat16)
            if bwords_host is not None:
                # sign words of (optionally group-summed) tokens; padded tokens
                # take the doc's FIRST VALID token's words
                src = tiled
                if self.coarse_pool > 1:
                    f = self.coarse_pool
                    src = tiled.reshape(t1 - t0, np_ // f, f, DOC_TILE, d).sum(axis=2)
                words, valid = binarize_words(torch.from_numpy(src).transpose(1, 2).flatten(0, 1))  # (C, Npc, W)
                bwords_host[t0:t1] = words_to_tile_major(fill_doc_padding(words, valid))
        return store_host, scales_host, bwords_host

    def _put_store(self, store_host, scales_host, bwords_host=None) -> None:
        self._store = store_host.to(self.device).contiguous()
        self._scales = None if scales_host is None else scales_host.to(self.device).contiguous()
        if bwords_host is not None:
            self._bwords = bwords_host.to(self.device).contiguous()

    # -- incremental ingestion ----------------------------------------------

    def extend(self, doc_embeddings: ArrayLike) -> None:
        """Append documents; doc ids continue from ``num_docs``.

        The partly filled tail tile is fetched to the host, its real docs
        dequantized and repacked with the new docs, and the packed tiles
        are concatenated onto the store on ``device`` (the device briefly
        holds the old and the new store)."""
        if isinstance(doc_embeddings, (list, tuple)):
            new_docs = [np.asarray(d, dtype=np.float32) for d in doc_embeddings]
        else:
            new_docs = list(np.asarray(doc_embeddings, dtype=np.float32))
        if not new_docs:
            return
        n_added = len(new_docs)
        if any(d.shape[-1] != self.dim for d in new_docs):
            raise ValueError(f"dim mismatch: index dim {self.dim}")
        too_long = max(d.shape[0] for d in new_docs)
        if too_long > self.doc_tokens:
            raise ValueError(f"new docs up to {too_long} tokens > doc_tokens={self.doc_tokens}")

        keep_tiles = self.num_docs // DOC_TILE
        tail = self.num_docs % DOC_TILE
        if tail:
            tile = self._store[keep_tiles].float()
            if self._scales is not None:
                tile = tile * self._scales[keep_tiles][..., None]
            tile = tile.cpu().numpy()
            new_docs = [tile[:, lane, :] for lane in range(tail)] + new_docs

        num_docs_new = self.num_docs + n_added
        n_total_tiles = round_up(num_docs_new, DOC_TILE) // DOC_TILE
        store_h, scales_h, bwords_h = self._pack_host(new_docs, n_tiles=n_total_tiles - keep_tiles)

        def cat(old, new_host):
            return torch.cat([old[:keep_tiles], new_host.to(self.device)]).contiguous()

        self._store = cat(self._store, store_h)
        if self._scales is not None:
            self._scales = cat(self._scales, scales_h)
        if self._bwords is not None:
            self._bwords = cat(self._bwords, bwords_h)
        self.num_docs = num_docs_new
        self.padded_docs = n_total_tiles * DOC_TILE

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the packed index to ``path`` (``.npz``, the JAX package's format)."""
        if not str(path).endswith(".npz"):  # np.savez appends it silently
            raise ValueError(f"Index path must end with .npz, got {path!r}")
        store = self._store.cpu()
        payload = {
            "store": store.view(torch.int16).numpy().view(np.uint16) if self.dtype == "bf16" else store.numpy(),
            "num_docs": np.int64(self.num_docs),
            "doc_tokens": np.int64(self.doc_tokens),
            "dim": np.int64(self.dim),
            "dtype": np.bytes_(self.dtype.encode()),
        }
        if self._scales is not None:
            payload["scales"] = self._scales.cpu().numpy()
        if self._bwords is not None:
            payload["bwords"] = self._bwords.cpu().numpy()
            payload["coarse_pool"] = np.int64(self.coarse_pool)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str, device: Device = "cuda", quantize_queries: bool = True) -> "CorpusIndex":
        """Restore an index written by :meth:`save` (of either package) onto ``device``."""
        with np.load(path) as data:
            dtype = bytes(data["dtype"]).decode()
            self = object.__new__(cls)
            self._init_common(
                dtype, device, quantize_queries,
                prefilter="binary" if "bwords" in data else None,
                coarse_pool=int(data["coarse_pool"]) if "coarse_pool" in data else 1,
            )
            self.num_docs = int(data["num_docs"])
            self.doc_tokens = int(data["doc_tokens"])
            self.dim = int(data["dim"])
            store = torch.from_numpy(np.array(data["store"]))
            if dtype == "bf16":
                store = store.view(torch.int16).view(torch.bfloat16)
            self.padded_docs = store.shape[0] * DOC_TILE
            self._put_store(
                store,
                torch.from_numpy(np.array(data["scales"])) if "scales" in data else None,
                torch.from_numpy(np.array(data["bwords"])) if "bwords" in data else None,
            )
        return self

    @property
    def nbytes(self) -> int:
        n = self._store.numel() * self._store.element_size()
        if self._scales is not None:
            n += self._scales.numel() * self._scales.element_size()
        if self._bwords is not None:
            n += self._bwords.numel() * 4
        return n

    # -- scoring ------------------------------------------------------------

    def _score_padded(self, queries: torch.Tensor) -> torch.Tensor:
        """(B, Nq, D) fp32 -> (B, padded_docs) fp32 exact scores."""
        if self.dtype == "int8":
            if self.quantize_queries:
                q_int8, q_scales = quantize_per_token(queries)
                return maxsim_int8mxu_tiled(q_int8, q_scales, self._store, self._scales)
            return maxsim_int8_tiled(queries, self._store, self._scales)
        return maxsim_tiled(queries, self._store)

    def score(self, query_embeddings: ArrayLike) -> np.ndarray:
        """Full score matrix ``(n_queries, num_docs)`` float32, by the exact
        sweep that :meth:`search` runs (K3 for an int8 index with quantized
        queries, else K4 or K5)."""
        scores = self._score_padded(self._prep_queries(query_embeddings))
        return scores[:, : self.num_docs].cpu().numpy().astype(np.float32, copy=False)

    def search(
        self,
        query_embeddings: ArrayLike,
        k: int = 10,
        candidates: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k ``(scores, doc_ids)`` per query.

        With ``prefilter="binary"`` the coarse pass shortlists
        ``candidates`` docs (default: ``default_candidates`` when set, else
        ``max(8*k, 64)``) and only those are rescored exactly: scores are
        exact, recall is approximate (see :meth:`estimate_recall`)."""
        queries = self._prep_queries(query_embeddings)
        k = min(k, self.num_docs)
        if self.prefilter == "binary":
            return self._search_tiered(queries, k, candidates)
        if candidates is not None:
            raise ValueError("candidates= requires an index built with prefilter='binary'")
        return self._search_exact(queries, k)

    def _mask_fake(self, scores: torch.Tensor) -> torch.Tensor:
        scores[:, self.num_docs :] = float("-inf")  # zero-padded docs of the last tile
        return scores

    def _search_exact(self, queries: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
        top_scores, top_idx = top_k(self._mask_fake(self._score_padded(queries)), k)
        return top_scores.cpu().numpy(), top_idx.cpu().numpy()

    def _search_tiered(
        self, queries: torch.Tensor, k: int, candidates: Optional[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        candidates = max(candidates or self.default_candidates or max(8 * k, 64), k)
        c = min(candidates, self.num_docs)
        q_words, q_valid = binarize_words(queries)
        coarse = self._mask_fake(binary_maxsim_tiled(q_words, q_valid, self._bwords, self.dim))
        _, cand = top_k(coarse, c)
        exact = gather_rerank(queries, self._store, self._scales, cand)
        top_scores, pos = top_k(exact, k)
        top_idx = torch.gather(cand, 1, pos.long())
        return top_scores.cpu().numpy(), top_idx.cpu().numpy()

    # -- recall management ---------------------------------------------------

    def exact_search(self, query_embeddings: ArrayLike, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by scoring every doc exactly, bypassing the prefilter (the
        recall oracle of :meth:`estimate_recall`)."""
        return self._search_exact(self._prep_queries(query_embeddings), min(k, self.num_docs))

    def estimate_recall(
        self, query_embeddings: ArrayLike, k: int = 10, candidates: Optional[int] = None
    ) -> float:
        """Recall@k of the two-tier path on sample queries: the mean share of
        the exact top-k that the shortlist + rerank returns."""
        if self.prefilter != "binary":
            raise ValueError("estimate_recall requires an index built with prefilter='binary'")
        k = min(k, self.num_docs)
        _, exact_idx = self.exact_search(query_embeddings, k=k)
        _, tiered_idx = self.search(query_embeddings, k=k, candidates=candidates)
        hits = sum(len(set(e.tolist()) & set(t.tolist())) for e, t in zip(exact_idx, tiered_idx))
        return hits / exact_idx.size

    def tune_candidates(
        self,
        query_embeddings: ArrayLike,
        k: int = 10,
        target_recall: float = 0.95,
        max_candidates: Optional[int] = None,
    ) -> Tuple[int, float]:
        """Double the shortlist from ``max(8k, 64)`` until measured recall@k
        reaches ``target_recall`` (or the cap, default the corpus size), pin
        it as :attr:`default_candidates` and return ``(candidates, recall)``."""
        if self.prefilter != "binary":
            raise ValueError("tune_candidates requires an index built with prefilter='binary'")
        cap = min(max_candidates or self.num_docs, self.num_docs)
        c = min(max(8 * k, 64), cap)
        _, exact_idx = self.exact_search(query_embeddings, k=min(k, self.num_docs))
        exact_sets = [set(row.tolist()) for row in exact_idx]
        while True:
            _, tiered_idx = self.search(query_embeddings, k=min(k, self.num_docs), candidates=c)
            hits = sum(len(s & set(t.tolist())) for s, t in zip(exact_sets, tiered_idx))
            recall = hits / exact_idx.size
            if recall >= target_recall or c >= cap:
                break
            c = min(2 * c, cap)
        self.default_candidates = c
        return c, recall

    def _prep_queries(self, qs: ArrayLike) -> torch.Tensor:
        if isinstance(qs, (list, tuple)):
            padded = pad_sequences([np.asarray(q, np.float32) for q in qs], pad_multiple=16)
        else:
            padded = np.asarray(qs, dtype=np.float32)
            if padded.ndim == 2:
                padded = padded[None]
        return torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)


def _pack_tiles_device(chunk: torch.Tensor, dtype: str, prefilter: Optional[str], coarse_pool: int = 1):
    """Pack ``(n * DOC_TILE, Np, D)`` fp32 docs into the tile-major serving
    arrays where they lie: ``(store, scales | None, bwords | None)``.
    Quantization is :func:`quantize_per_token` (the scale is
    ``absmax * fp32(1/127)``, as the JAX package's jitted packer computes
    it), which may differ in the last bit from ``_pack_host``'s numpy
    ``absmax / 127``."""
    c, np_, d = chunk.shape
    tiled = chunk.reshape(c // DOC_TILE, DOC_TILE, np_, d).transpose(1, 2)
    if dtype == "int8":
        store, scales = quantize_per_token(tiled)
        store, scales = store.contiguous(), scales.contiguous()
    else:
        store, scales = tiled.to(torch.bfloat16).contiguous(), None
    bwords = None
    if prefilter == "binary":
        src = chunk
        if coarse_pool > 1:
            # padding tokens are zero by the add() convention, so the plain
            # group sum is the sum over valid tokens
            src = chunk.reshape(c, np_ // coarse_pool, coarse_pool, d).sum(dim=2)
        words, valid = binarize_words(src)  # (c, Npc, W), (c, Npc)
        bwords = words_to_tile_major(fill_doc_padding(words, valid)).contiguous()
    return store, scales, bwords


class DeviceIndexBuilder:
    """Streaming index construction on the device (counterpart of the JAX
    package's ``DeviceIndexBuilder``).

    Model forwards hand padded ``(B, S, D)`` embeddings and validity masks
    straight to :meth:`add`; quantization, sign packing and the tile-major
    layout all run where the embeddings lie, and :meth:`build` returns a
    :class:`CorpusIndex` on that device without a host round trip.

    Args:
        doc_tokens: token budget per doc (rounded up to a multiple of 16);
            shorter batches are zero-padded, longer ones are an error.
        dim: embedding dimension.
        dtype / prefilter / coarse_pool / quantize_queries: as in
            :class:`CorpusIndex`.
        pool_factor: token pooling during ingestion: each added batch is
            pooled where it lies before it is quantized and packed, so
            embed -> pool -> index never leaves the device. ``doc_tokens``
            then bounds the pooled length (``S // pool_factor``).
        pool_method: ``"ward"`` (default), exact Ward clustering
            (:func:`~colpali_tpu_torch.compression.token_pooling.ward_pool_padded`,
            the partitions of the scipy ``HierarchicalTokenPooler``), or
            ``"kmeans"``, spherical k-means over ``pool_iters`` rounds
            (:func:`~colpali_tpu_torch.compression.token_pooling.kmeans_pool_padded`),
            cheaper and keeping less of MaxSim.
    """

    def __init__(self, doc_tokens: int, dim: int, dtype: str = "int8", prefilter: Optional[str] = None,
                 pool_factor: Optional[int] = None, pool_iters: int = 10, pool_method: str = "ward",
                 coarse_pool: int = 1, quantize_queries: bool = True):
        self._pool = None
        if pool_factor is not None and pool_factor > 1:
            from colpali_tpu_torch.compression.token_pooling import kmeans_pool_padded, ward_pool_padded

            if pool_method == "ward":
                self._pool = functools.partial(ward_pool_padded, pool_factor=pool_factor)
            elif pool_method == "kmeans":
                self._pool = functools.partial(kmeans_pool_padded, pool_factor=pool_factor, iters=pool_iters)
            else:
                raise ValueError(f"pool_method must be 'ward' or 'kmeans', got {pool_method!r}")
        self.pool_factor = pool_factor
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"Unsupported index dtype: {dtype}")
        if prefilter not in (None, "binary"):
            raise ValueError(f"Unsupported prefilter: {prefilter!r} (None or 'binary')")
        if coarse_pool < 1:
            raise ValueError(f"coarse_pool must be >= 1, got {coarse_pool}")
        if coarse_pool > 1 and prefilter != "binary":
            raise ValueError("coarse_pool > 1 requires prefilter='binary'")
        self.doc_tokens = round_up(doc_tokens, 16)
        if self.doc_tokens % coarse_pool != 0:
            raise ValueError(f"coarse_pool={coarse_pool} must divide doc_tokens={self.doc_tokens}")
        if prefilter == "binary" and dim % 32 != 0:
            raise ValueError(f"binary prefilter needs dim % 32 == 0, got {dim}")
        self.dim = dim
        self.dtype = dtype
        self.prefilter = prefilter
        self.coarse_pool = coarse_pool
        self.quantize_queries = quantize_queries
        self.num_docs = 0
        self._built = False
        self._tiles: list = []  # (store, scales, bwords) per packed chunk
        self._pending: list = []  # (B, Np, D) fp32 batches, less than one tile in all

    def add(self, embeddings: torch.Tensor, mask: Optional[torch.Tensor] = None) -> None:
        """Ingest ``(B, S, D)`` embeddings (a padded model output); tokens
        where ``mask (B, S)`` is 0 are zeroed, the score-neutral padding.
        With ``pool_factor`` the batch is pooled first (a mask of ones when
        none is given)."""
        if self._built:
            raise RuntimeError("DeviceIndexBuilder already finalized by build(); create a new one "
                               "(or use CorpusIndex.extend) to add more docs")
        if self._pool is not None:
            mask = torch.ones(embeddings.shape[:2], device=embeddings.device) if mask is None else \
                torch.as_tensor(mask, device=embeddings.device).float()
            embeddings, mask, _ = self._pool(embeddings, mask)
        b, s, d = embeddings.shape
        if d != self.dim:
            raise ValueError(f"dim mismatch: index {self.dim}, batch {d}")
        if s > self.doc_tokens:
            raise ValueError(f"batch has {s} tokens > doc_tokens={self.doc_tokens}; pool upstream or raise "
                             "doc_tokens")
        if self._pending and embeddings.device != self._pending[0].device:
            raise ValueError(f"batch is on {embeddings.device}, earlier ones on {self._pending[0].device}")
        x = embeddings.detach().float()
        if mask is not None:
            x = x * torch.as_tensor(mask, device=x.device).float()[..., None]
        if s < self.doc_tokens:
            x = torch.nn.functional.pad(x, (0, 0, 0, self.doc_tokens - s))
        self.num_docs += b
        self._pending.append(x)
        self._flush(final=False)

    def _flush(self, final: bool) -> None:
        buffered = sum(int(p.shape[0]) for p in self._pending)
        full = (buffered // DOC_TILE) * DOC_TILE
        target = round_up(buffered, DOC_TILE) if final else full
        if target == 0:
            return
        chunk = self._pending[0] if len(self._pending) == 1 else torch.cat(self._pending)
        if buffered < target:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, 0, 0, target - buffered))
        take, rest = chunk[:target], chunk[target:]
        self._pending = [rest] if rest.shape[0] else []
        self._tiles.append(_pack_tiles_device(take, self.dtype, self.prefilter, self.coarse_pool))

    def build(self) -> CorpusIndex:
        """Finalize into a :class:`CorpusIndex` on the embeddings' device."""
        if self._built:
            raise RuntimeError("DeviceIndexBuilder already finalized by build()")
        if self.num_docs == 0:
            raise ValueError("No documents added")
        self._built = True
        self._flush(final=True)
        store = torch.cat([t[0] for t in self._tiles])
        scales = None if self.dtype != "int8" else torch.cat([t[1] for t in self._tiles])
        bwords = None if self.prefilter is None else torch.cat([t[2] for t in self._tiles])
        self._tiles = []
        index = object.__new__(CorpusIndex)
        index._init_common(self.dtype, store.device, self.quantize_queries, self.prefilter, self.coarse_pool)
        index.num_docs = self.num_docs
        index.doc_tokens = self.doc_tokens
        index.dim = self.dim
        index.padded_docs = store.shape[0] * DOC_TILE
        index._put_store(store, scales, bwords)
        return index
