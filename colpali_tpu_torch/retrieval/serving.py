"""Serving-side search dispatch: routing, micro-batching and query encoding
(PyTorch counterpart of :mod:`colpali_tpu.retrieval.serving`).

- :func:`route` picks the sweep per merged batch: two-tier for small
  batches on a prefilter index, exact otherwise (one exact sweep over B
  queries reads the corpus once for all of them).
- :class:`MicroBatcher` merges concurrent search requests into one sweep;
  :class:`EncodeBatcher` merges concurrent text-encode requests into one
  forward of :class:`QueryEncoder`.
- Every sweep and forward runs at bucketed shapes (power-of-two batch,
  fixed query-token pad, one top-k bucket), so merged requests never
  change results and :meth:`MicroBatcher.warmup` covers every shape.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: merged-batch size above which the exact sweep is used instead of the two-tier path
DEFAULT_EXACT_THRESHOLD = 4


def route(index, n_queries: int, mode: str = "auto",
          exact_threshold: int = DEFAULT_EXACT_THRESHOLD) -> str:
    """Resolve the sweep for ``n_queries``: ``"exact"`` or ``"tiered"``.

    mode: ``"auto"`` (batch-size rule), ``"exact"`` (force the full sweep),
    ``"tiered"`` (force the prefilter; error if the index has none).
    """
    if mode == "exact":
        return "exact"
    if mode == "tiered":
        if index.prefilter is None:
            raise ValueError("mode='tiered' requires an index built with a prefilter")
        return "tiered"
    if mode != "auto":
        raise ValueError(f"unknown mode {mode!r}; expected auto|exact|tiered")
    if index.prefilter is None or n_queries > exact_threshold:
        return "exact"
    return "tiered"


def run_search(index, queries: Sequence[np.ndarray], k: int,
               candidates: Optional[int] = None, mode: str = "auto",
               exact_threshold: int = DEFAULT_EXACT_THRESHOLD,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One routed sweep: ``(scores, doc_ids)`` for all ``queries``."""
    kernel = route(index, len(queries), mode, exact_threshold)
    if kernel == "exact":
        return index.exact_search(queries, k=k) if index.prefilter is not None \
            else index.search(queries, k=k)
    return index.search(queries, k=k, candidates=candidates)


def _pow2_bucket(n: int, start: int = 1) -> int:
    """The least ``start * 2**i`` that is >= ``n``."""
    b = start
    while b < n:
        b *= 2
    return b


def _k_bucket(k: int, num_docs: int) -> int:
    """Round ``k`` up to a power of two (min 16), capped at the corpus size."""
    return min(_pow2_bucket(k, 16), num_docs)


class QueryEncoder:
    """In-process text-query encoding for text-in serving.

    Wraps a retriever ``model`` (an ``nn.Module`` taking ``input_ids`` and
    ``attention_mask``; it lives on its parameters' device) and its
    ``processor``. Batches pad to a power-of-two bucket with rows that
    replicate row 0 (an all-masked row would NaN the softmax), and the token
    axis zero-pads on the right to a power-of-two bucket of at least
    ``token_bucket_min``; M-RoPE ``position_ids (3, B, T)`` pad the same
    way along their batch and token axes. ``encode`` returns per-query ``(tokens_i, dim)``
    float32 arrays, what :meth:`MicroBatcher.search` takes.
    """

    def __init__(self, model: torch.nn.Module, processor, max_batch: int = 32,
                 token_bucket_min: int = 32):
        self.model = model.eval()
        self.processor = processor
        self.device = next(model.parameters()).device
        self.max_batch = max_batch
        self.token_bucket_min = token_bucket_min

    def _pad_static(self, batch: dict) -> tuple:
        """Pad a processed text batch to (batch bucket, token bucket)."""
        batch = {k: np.asarray(v) for k, v in batch.items()}
        n, t = batch["input_ids"].shape
        nb = _pow2_bucket(n)
        tb = _pow2_bucket(t, self.token_bucket_min)
        out = {}
        for k, v in batch.items():
            if v.ndim == 3 and v.shape[1] == n:  # (3, B, T) M-RoPE positions: batch on axis 1
                v = np.concatenate([v, np.repeat(v[:, :1], nb - n, axis=1)], axis=1)
                v = np.pad(v, ((0, 0), (0, 0), (0, tb - v.shape[2])))
            elif v.ndim >= 1 and v.shape[0] == n:  # (B, T...) token arrays
                v = np.concatenate([v, np.repeat(v[:1], nb - n, axis=0)], axis=0)
                if v.ndim >= 2 and v.shape[1] == t:
                    pad = [(0, 0)] * v.ndim
                    pad[1] = (0, tb - t)
                    v = np.pad(v, pad)
            out[k] = v
        return out, n

    def encode(self, texts: Sequence[str]) -> List[np.ndarray]:
        """Texts -> per-query L2-normalized multi-vector embeddings."""
        if not texts:
            raise ValueError("empty text batch")
        if len(texts) > self.max_batch:
            parts = []
            for i in range(0, len(texts), self.max_batch):
                parts.extend(self.encode(texts[i : i + self.max_batch]))
            return parts
        feed, n = self._pad_static(self.processor.process_queries(list(texts)))
        with torch.inference_mode():
            out = self.model(**{k: torch.from_numpy(v).to(self.device) for k, v in feed.items()})
            out = out.float().cpu().numpy()
        mask = feed["attention_mask"].astype(bool)
        return [out[i][mask[i]] for i in range(n)]

    def warmup(self) -> None:
        """Run every batch bucket once at the default token bucket."""
        b = 1
        while b <= self.max_batch:
            self.encode(["warmup query"] * b)
            b *= 2


class _Request:
    """One caller's request: its ``items`` (texts or query embeddings) and
    options in, ``result`` or ``error`` out, ``event`` set when done."""

    __slots__ = ("items", "options", "event", "result", "error")

    def __init__(self, items: list, options: tuple = ()):
        self.items = items
        self.options = options
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Batcher:
    """A request queue drained by one dispatcher thread. The first queued
    request opens a linger window; requests queued before it closes join the
    batch up to ``cap`` items, and one request is never split. Subclasses
    run each group of a batch in :meth:`_run`; an exception there reaches
    every caller of the group."""

    def __init__(self, window_ms: float, cap: int, name: str):
        self.window = window_ms / 1e3
        self._cap = cap
        self._queue: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    def _submit(self, request: _Request):
        """Blocking; safe from many threads. Returns the request's result."""
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{type(self).__name__} is closed")
            self._queue.append(request)
            self._cv.notify()
        request.event.wait()
        if request.error is not None:
            raise request.error
        return request.result

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _take_batch(self) -> List[_Request]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
        total = len(batch[0].items)
        deadline = time.perf_counter() + self.window
        while total < self._cap:
            remaining = deadline - time.perf_counter()
            with self._cv:
                if not self._queue:
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(remaining)
                while self._queue and total < self._cap:
                    nxt = self._queue[0]
                    if total + len(nxt.items) > self._cap:
                        total = self._cap
                        break
                    batch.append(self._queue.popleft())
                    total += len(nxt.items)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed and drained
            for group in self._groups(batch):
                try:
                    self._run(group)
                except BaseException as exc:  # noqa: BLE001 — delivered to each caller
                    for r in group:
                        r.error = exc
                finally:
                    for r in group:
                        r.event.set()

    def _groups(self, batch: List[_Request]) -> List[List[_Request]]:
        return [batch]

    def _run(self, group: List[_Request]) -> None:
        raise NotImplementedError


class EncodeBatcher(_Batcher):
    """Merge concurrent text-encode requests into single forwards: a
    dispatcher thread drains the queue, batches up to ``max_texts`` within a
    linger window, and runs one :meth:`QueryEncoder.encode`."""

    def __init__(self, encoder: QueryEncoder, window_ms: float = 2.0,
                 max_texts: Optional[int] = None):
        self.encoder = encoder
        self.max_texts = max_texts or encoder.max_batch
        super().__init__(window_ms, self.max_texts, name="encode-microbatcher")

    def encode(self, texts: Sequence[str]) -> List[np.ndarray]:
        """Blocking; safe from many threads. Returns per-text embeddings."""
        if not texts:
            raise ValueError("empty text batch")
        return self._submit(_Request(list(texts)))

    def warmup(self) -> None:
        self.encoder.warmup()

    def _run(self, group: List[_Request]) -> None:
        embs = self.encoder.encode([t for r in group for t in r.items])
        row = 0
        for r in group:
            r.result = embs[row : row + len(r.items)]
            row += len(r.items)


class MicroBatcher(_Batcher):
    """Merge concurrent search requests into single device sweeps.

    Args:
        index: a :class:`~colpali_tpu_torch.retrieval.store.CorpusIndex`.
        window_ms: linger after the first queued request before dispatch
            (0: merge only what piles up during a sweep).
        max_queries: cap on merged queries per sweep.
        exact_threshold: see :func:`route`.
        lock: optional lock held during each sweep; share it with index
            mutators (``extend``) so searches never race an update.
        query_token_pad: every sweep zero-pads its queries to this many
            tokens (zero tokens score 0 in every path); None disables it.
        k_bucket: every sweep runs at this top-k (capped at the corpus
            size) and each request slices its own k back out.
    """

    def __init__(self, index, window_ms: float = 2.0, max_queries: int = 64,
                 exact_threshold: int = DEFAULT_EXACT_THRESHOLD,
                 lock: Optional[threading.Lock] = None,
                 query_token_pad: Optional[int] = 64,
                 k_bucket: int = 128):
        self.index = index
        self.max_queries = max_queries
        self.exact_threshold = exact_threshold
        self.k_bucket = k_bucket
        self.query_token_pad = query_token_pad
        self.lock = lock if lock is not None else threading.Lock()
        super().__init__(window_ms, max_queries, name="search-microbatcher")

    def search(self, queries: Sequence[np.ndarray], k: int = 10,
               candidates: Optional[int] = None, mode: str = "auto",
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking search, safe from many threads: per-request
        ``(scores (n, k'), doc_ids (n, k'))`` with ``k' = min(k, num_docs)``,
        identical to ``index.search``."""
        if not queries:
            raise ValueError("empty query batch")
        route(self.index, len(queries), mode, self.exact_threshold)  # validate early
        return self._submit(_Request([np.asarray(q, np.float32) for q in queries],
                                     (int(k), candidates, mode)))

    def warmup(self, max_batch: Optional[int] = None,
               query_tokens: Optional[int] = None) -> None:
        """One dummy sweep per reachable (batch bucket, route): exact at every
        power-of-two bucket up to ``max_batch`` (default ``max_queries``),
        tiered up to the exact threshold's power-of-two ceiling. This builds
        the kernels and sizes the allocator before live traffic."""
        limit = max_batch or self.max_queries
        tokens = query_tokens or self.query_token_pad or 16
        q = np.zeros((tokens, self.index.dim), np.float32)
        k = min(self.k_bucket, self.index.num_docs)
        tiered_limit = _pow2_bucket(self.exact_threshold)
        b = 1
        while b <= limit:
            kernels = ["exact"]
            if self.index.prefilter is not None and b <= tiered_limit:
                kernels.append("tiered")
            for kernel in kernels:
                with self.lock:
                    run_search(self.index, [q] * b, k=k, mode=kernel,
                               exact_threshold=self.exact_threshold)
            b *= 2

    def _groups(self, batch: List[_Request]) -> List[List[_Request]]:
        # requests in one sweep must agree on shortlist size; explicit modes
        # are honored by grouping, auto requests merge freely
        groups: dict = {}
        for r in batch:
            _, candidates, mode = r.options
            groups.setdefault((candidates, mode), []).append(r)
        return list(groups.values())

    def _run(self, group: List[_Request]) -> None:
        _, candidates, mode = group[0].options
        flat = [q for r in group for q in r.items]
        # route on the true query count, then pad the sweep to static
        # shapes: a power-of-two batch (pad rows reuse queries[0]), the
        # k bucket, query_token_pad tokens (zero tokens score 0); the
        # padding is sliced off before delivery
        k_req = max(r.options[0] for r in group)
        if k_req <= self.k_bucket:
            k = min(self.k_bucket, self.index.num_docs)
        else:
            k = _k_bucket(k_req, self.index.num_docs)
        kernel = route(self.index, len(flat), mode, self.exact_threshold)
        n_real = len(flat)
        flat = flat + [flat[0]] * (_pow2_bucket(n_real) - n_real)
        pad = self.query_token_pad
        if pad is not None and all(q.shape[0] <= pad for q in flat):
            flat = [
                q if q.shape[0] == pad
                else np.concatenate([q, np.zeros((pad - q.shape[0], q.shape[1]), np.float32)])
                for q in flat
            ]
        with self.lock:
            scores, ids = run_search(
                self.index, flat, k=k, candidates=candidates, mode=kernel,
                exact_threshold=self.exact_threshold,
            )
        scores, ids = scores[:n_real], ids[:n_real]
        row = 0
        for r in group:
            n, kk = len(r.items), min(r.options[0], scores.shape[1])
            r.result = (scores[row : row + n, :kk], ids[row : row + n, :kk])
            row += n
