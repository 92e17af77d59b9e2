"""Token pooling: compress multi-vector embeddings by clustering their tokens
(counterpart of :mod:`colpali_tpu.compression.token_pooling`).

- :class:`HierarchicalTokenPooler`: the cosine similarities of a whole batch
  from one padded product on the pooler's device, then Ward linkage and a
  maxclust cut per document with scipy on the host (``linkage(1 - sim,
  metric="euclidean", method="ward")``), ``max(len // pool_factor, 1)``
  clusters, each pooled to its re-L2-normalized mean.
- :func:`ward_pool_padded`: the same partitions computed on the device by
  greedy global-argmin merging with the Lance-Williams Ward update, for a
  padded batch; :class:`DeviceWardTokenPooler` wraps it.
- :func:`kmeans_pool_padded`: batched spherical k-means on the device
  (farthest-point initialisation, ``iters`` rounds, a hard final
  aggregation); :class:`KMeansTokenPooler` wraps it.
- :class:`LambdaTokenPooler`: a user function per document.

The poolers take a ragged list of 2-D arrays or a zero-padded 3-D array
(``padding=True``, left or right) and give the container back in the same
shape; inputs may be numpy arrays or tensors, outputs are numpy arrays. The
device functions take and return tensors where they lie. Their products are
fp32 with TF32 off whatever the process's setting (the JAX package's
``precision="highest"``): a TF32 Gram flips near-tied merges.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from colpali_tpu_torch.utils.tensor_utils import as_numpy, pad_sequences, unbind_padded_multivector_embeddings

Array = np.ndarray


@contextlib.contextmanager
def exact_fp32_products():
    """fp32 products without TF32 inside, the process's setting restored
    after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@dataclasses.dataclass
class TokenPoolingOutput:
    """pooled_embeddings and, optionally, each document's cluster id -> token indices."""

    pooled_embeddings: Union[List[Array], Array]
    cluster_id_to_indices: Optional[List[Dict[int, Tuple[Array]]]] = None


class BaseTokenPooler:
    """The list / padded 3-D container around a pooling implementation."""

    def _pool_embeddings_impl(
        self, embeddings: List[Array], **kwargs
    ) -> Tuple[List[Array], Optional[List[Dict[int, Tuple[Array]]]]]:
        raise NotImplementedError

    def pool_embeddings(
        self,
        embeddings: Union[Array, torch.Tensor, List[Any]],
        return_dict: bool = False,
        padding: bool = False,
        padding_side: str = "left",
        num_workers: Optional[int] = None,
        **pool_kwargs,
    ) -> Union[Union[Array, List[Array]], TokenPoolingOutput]:
        if isinstance(embeddings, (list, tuple)) and not embeddings:
            return TokenPoolingOutput(pooled_embeddings=[], cluster_id_to_indices=[])

        is_3d = not isinstance(embeddings, (list, tuple)) and as_numpy(embeddings).ndim == 3
        if is_3d:
            arr = as_numpy(embeddings)
            prepared = unbind_padded_multivector_embeddings(arr, 0.0, padding_side) if padding else list(arr)
        else:
            prepared = [as_numpy(e) for e in embeddings]
            if any(e.ndim != 2 for e in prepared):
                raise ValueError("The input must be a list of 2D arrays or a 3D array.")

        pooled, maps = self._pool_embeddings_impl(prepared, num_workers=num_workers, **pool_kwargs)

        if is_3d:
            pooled = pad_sequences(pooled, padding_side=padding_side)
        if not return_dict:
            return pooled
        return TokenPoolingOutput(pooled_embeddings=pooled, cluster_id_to_indices=maps)


class HierarchicalTokenPooler(BaseTokenPooler):
    """Ward-linkage hierarchical clustering: the similarity products on
    ``device``, the linkage with scipy on the host."""

    def __init__(self, device: Any = "cuda"):
        self.device = torch.device(device)

    def _pool_embeddings_impl(self, embeddings: List[Array], pool_factor: int, num_workers: Optional[int] = None):
        sims = self._batched_similarities(embeddings)

        def pool_one(args):
            emb, sim = args
            return _ward_pool(emb, sim, pool_factor)

        work = list(zip(embeddings, sims))
        if num_workers and num_workers > 1:
            with ThreadPoolExecutor(num_workers) as ex:
                results = list(ex.map(pool_one, work))
        else:
            results = [pool_one(w) for w in work]
        return [r[0] for r in results], [r[1] for r in results]

    def _batched_similarities(self, embeddings: List[Array]) -> List[Array]:
        padded = pad_sequences(embeddings, pad_multiple=8)  # (B, L, D)
        x = torch.from_numpy(np.ascontiguousarray(padded, np.float32)).to(self.device)
        with exact_fp32_products():
            sims = torch.bmm(x, x.transpose(1, 2)).cpu().numpy()
        return [sims[i, : e.shape[0], : e.shape[0]] for i, e in enumerate(embeddings)]


def _ward_pool(embedding: Array, similarities: Array, pool_factor: int) -> Tuple[Array, Dict[int, Tuple[Array]]]:
    """One document: Ward clustering of ``1 - sim`` (its rows as
    observations, as the reference passes them to scipy), the maxclust cut,
    each cluster's mean re-normalized."""
    from scipy.cluster.hierarchy import fcluster, linkage

    embedding = np.asarray(embedding, np.float32)
    token_length = embedding.shape[0]
    if embedding.ndim != 2:
        raise ValueError("The input tensor must be a 2D tensor.")
    if token_length == 1:
        raise ValueError("The input tensor must have more than one token.")
    if pool_factor == 1:
        return embedding, {0: (np.arange(token_length),)}

    distances = 1 - np.asarray(similarities, np.float32)
    Z = linkage(distances, metric="euclidean", method="ward")  # noqa: N806
    max_clusters = max(token_length // pool_factor, 1)
    labels = fcluster(Z, t=max_clusters, criterion="maxclust") - 1

    cluster_id_to_indices: Dict[int, Tuple[Array]] = {}
    pooled_rows: List[Array] = []
    for cluster_id in range(max_clusters):
        idx = np.where(labels == cluster_id)[0]
        cluster_id_to_indices[cluster_id] = (idx,)
        if idx.size > 0:
            mean = embedding[idx].mean(axis=0)
            norm = np.linalg.norm(mean)
            pooled_rows.append(mean / norm if norm > 0 else mean)
    return np.stack(pooled_rows, axis=0), cluster_id_to_indices


def _identity_pool(embeddings: torch.Tensor, mask: torch.Tensor):
    t = embeddings.shape[1]
    mask = torch.as_tensor(mask, device=embeddings.device)
    return embeddings, mask.bool(), torch.arange(t, device=embeddings.device).expand(mask.shape)


def _aggregate(e: torch.Tensor, m: torch.Tensor, assign: torch.Tensor, k: int):
    """Each cluster's mean of its valid tokens, re-normalized, as one-hot
    products (fixed sums, where a scatter would add in launch order), and
    its count ``(B, K, 1)``."""
    onehot = F.one_hot(assign.clamp_min(0), k).float() * m[..., None]  # (B, T, K)
    sums = torch.bmm(onehot.transpose(1, 2), e)
    counts = onehot.sum(dim=1)[..., None]
    mean = sums / counts.clamp_min(1.0)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp_min(1e-12), counts


def _ward_merges(e: torch.Tensor, m: torch.Tensor, pool_factor: int, record: Optional[torch.Tensor] = None):
    """The greedy merging of :func:`ward_pool_padded` over fp32 ``e (B, T,
    D)`` and ``m (B, T)`` (TF32 off): each token's root label ``(B, T)``.
    ``record``, a ``(T - K, B, 2)`` integer tensor, takes each step's merged
    pair ``(i, j)`` (junk for a document past its cut)."""
    dev = e.device
    b, t, _ = e.shape
    k = max(t // pool_factor, 1)
    n = m.sum(dim=1)
    k_i = torch.div(n, pool_factor, rounding_mode="floor").int().clamp_min(1)
    merges_needed = n.int() - k_i

    sim = torch.bmm(e, e.transpose(1, 2))
    x = (1.0 - sim) * m[:, None, :]
    sq = (x * x).sum(dim=2)
    gram = torch.bmm(x, x.transpose(1, 2))
    dist = sq[:, :, None] + sq[:, None, :] - 2.0 * gram  # squared euclidean distances
    del sim, x, gram

    inf = torch.finfo(torch.float32).max
    valid = m > 0
    upper = torch.ones((t, t), dtype=torch.bool, device=dev).triu(1)
    dist = torch.where(valid[:, :, None] & valid[:, None, :] & upper, dist.clamp_min(0.0), inf)

    sizes = m.clone()
    labels = torch.arange(t, device=dev).expand(b, t).contiguous()
    flat = dist.view(b, t * t)
    ar = torch.arange(t, device=dev)
    fresh = torch.full((b, 4, t), inf, device=dev)  # what a step writes: rows i and j, columns i and j
    step = torch.zeros(1, dtype=torch.long, device=dev)

    def merge() -> None:
        """One step, in place and without a host synchronisation."""
        keep = (merges_needed <= step)[:, None, None]  # documents already cut keep their state
        idx = flat.argmin(dim=1)
        pair = torch.stack((idx // t, idx % t), dim=1)  # (B, 2): i < j
        if record is not None:
            record.index_copy_(0, step, pair[None])
        # rows i and j of the symmetric distances: the lower triangle holds inf, so each is the row right of the
        # diagonal and the column above it, read as one gather of the flat matrix
        at_row = pair[..., None] * t + ar  # (B, 2, T): (i, k) and (j, k)
        at_col = ar * t + pair[..., None]  # (k, i) and (k, j)
        at = torch.cat((at_row, at_col), dim=1).view(b, 4 * t)
        old = flat.gather(1, at).view(b, 4, t)
        right = ar > pair[..., None]
        row_i, row_j = torch.where(right, old[:, :2], old[:, 2:]).unbind(1)
        i, j = pair[:, :1], pair[:, 1:]
        d_ij = row_i.gather(1, j)
        s_i, s_j = sizes.gather(1, i), sizes.gather(1, j)
        new = ((s_i + sizes) * row_i + (s_j + sizes) * row_j - sizes * d_ij) / (s_i + s_j + sizes).clamp_min(1e-20)
        new = torch.where((sizes > 0) & (ar != i) & (ar != j), new, inf)
        # row i right of the diagonal and column i above it take the new distances, row and column j die; the
        # cells written twice ((i, i), (i, j), (j, i), (j, j)) take inf both times
        fresh[:, 0] = torch.where(right[:, 0], new, inf)
        fresh[:, 2] = torch.where(ar < i, new, inf)
        flat.scatter_(1, at, torch.where(keep, old, fresh).view(b, 4 * t))
        sizes.copy_(torch.where(keep[:, 0], sizes, sizes + (ar == i) * s_j - (ar == j) * sizes))
        labels.copy_(torch.where(~keep[:, 0] & (labels == j), i, labels))
        step.add_(1)

    steps = t - k  # merges_i is largest at n_i = T
    if dev.type == "cuda" and steps > 1:
        # the step's ~30 small launches cost the host more than the card: the first step runs as the warm-up,
        # the rest replay it from a CUDA graph. The capture runs on a side stream in thread-local mode, not through
        # torch.cuda.graph (which synchronizes and empties the allocator's cache on entry): another thread's CUDA
        # calls, such as a prefetch thread's pinned allocations, neither join nor invalidate it
        merge()
        graph, side, main = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                merge()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        for _ in range(steps - 1):
            graph.replay()
    else:
        for _ in range(steps):
            merge()
    return labels


def ward_pool_padded(embeddings: torch.Tensor, mask: torch.Tensor, pool_factor: int):
    """Exact Ward pooling of a padded batch on its device: the partitions of
    :class:`HierarchicalTokenPooler` (scipy) without leaving the device.

    ``embeddings (B, T, D)`` with zero rows where ``mask (B, T)`` is 0. The
    observations are the rows of ``X = 1 - sim`` over the valid columns;
    their squared distances come from one Gram product, and each step merges
    the closest pair over all documents at once (the first minimum of the
    flattened upper triangle, ``i < j``: scipy's tie order), updating the
    merged row and column by Lance-Williams (:func:`_ward_merges`). Ward is a
    reducible linkage, so stopping document ``i`` after ``n_i - k_i``
    merges, ``k_i = max(n_i // pool_factor, 1)``, is the maxclust cut.
    ``T - K`` steps of one argmin over the batch's ``T x T`` distances and
    row and column updates, with no host synchronisation.

    Returns ``(pooled (B, K, D), cluster_mask (B, K), assignments (B, T))``
    with ``K = max(T // pool_factor, 1)``: re-normalized cluster means in
    the input's dtype (invalid clusters zeroed) and compact cluster ids of
    the valid tokens (junk where ``mask`` is 0).
    """
    if pool_factor == 1:
        return _identity_pool(embeddings, mask)
    dev = embeddings.device
    with exact_fp32_products():
        e = embeddings.float()
        m = torch.as_tensor(mask, device=dev).float()
        b, t, _ = e.shape
        k = max(t // pool_factor, 1)
        labels = _ward_merges(e, m, pool_factor)
        # the surviving roots, numbered in index order (only the partition is the reference's)
        is_root = torch.zeros((b, t), device=dev).scatter_add_(1, labels, m) > 0
        rank = is_root.int().cumsum(dim=1) - 1
        compact = rank.gather(1, labels).clamp_max(k - 1)
        pooled, counts = _aggregate(e, m, compact, k)
        cluster_mask = counts[..., 0] > 0
        pooled = torch.where(cluster_mask[..., None], pooled, 0.0)
    return pooled.to(embeddings.dtype), cluster_mask, compact


def kmeans_pool_padded(embeddings: torch.Tensor, mask: torch.Tensor, pool_factor: int, iters: int = 10):
    """Batched spherical k-means pooling on the device: the same cluster
    count rule as Ward (``k_i = max(n_i // pool_factor, 1)``) and the same
    aggregation.

    Centroids start from each document's first valid token, then
    repeatedly the valid token with the lowest maximum similarity to those
    chosen (farthest point); ``iters`` rounds of assignment and mean follow,
    an empty cluster keeping its centroid, and clusters ``j >= k_i`` take no
    token. The pooled rows are then aggregated hard from the final
    assignment; clusters that end empty, and every cluster of a fully masked
    document, are invalid and zeroed. ``argmin``/``argmax`` take the first
    index.

    Returns ``(pooled (B, K, D), cluster_mask (B, K), assignments (B, T))``
    with ``K = max(T // pool_factor, 1)``.
    """
    if pool_factor == 1:
        return _identity_pool(embeddings, mask)
    dev = embeddings.device
    with exact_fp32_products():
        e = embeddings.float()
        m = torch.as_tensor(mask, device=dev).float()
        b, t, d = e.shape
        k = max(t // pool_factor, 1)
        n = m.sum(dim=1)
        k_i = torch.div(n, pool_factor, rounding_mode="floor").int().clamp_min(1)
        cluster_mask = torch.arange(k, device=dev)[None] < k_i[:, None]
        neg = torch.finfo(torch.float32).min
        valid = m > 0
        rows = torch.arange(b, device=dev)

        centroids = torch.empty((b, k, d), device=dev)
        centroids[:, 0] = e[rows, valid.int().argmax(dim=1)]  # the first valid token (index 0 when none)
        maxsim = torch.where(valid, torch.bmm(e, centroids[:, 0, :, None])[..., 0], torch.inf)
        for c in range(1, k):
            centroids[:, c] = e[rows, maxsim.argmin(dim=1)]
            sim = torch.bmm(e, centroids[:, c, :, None])[..., 0]
            maxsim = torch.where(valid, torch.maximum(maxsim, sim), torch.inf)

        def assign_to(c: torch.Tensor) -> torch.Tensor:
            sim = torch.where(cluster_mask[:, None, :], torch.bmm(e, c.transpose(1, 2)), neg)
            return sim.argmax(dim=-1)

        for _ in range(iters):
            mean, counts = _aggregate(e, m, assign_to(centroids), k)
            centroids = torch.where(counts > 0, mean, centroids)
        assign = assign_to(centroids)
        pooled, counts = _aggregate(e, m, assign, k)
        cluster_mask = cluster_mask & (counts[..., 0] > 0)
        pooled = torch.where(cluster_mask[..., None], pooled, 0.0)
    return pooled.to(embeddings.dtype), cluster_mask, assign


class _DevicePoolerBase(BaseTokenPooler):
    """Ragged list -> one right-padded ``(B, L, D)`` batch on ``device``,
    pooled in one call, then unpadded: empty clusters are dropped and the
    rest renumbered, as the scipy pooler keeps only non-empty clusters."""

    def __init__(self, device: Any = "cuda"):
        self.device = torch.device(device)

    def _pool_padded(self, padded: torch.Tensor, mask: torch.Tensor, pool_factor: int):
        raise NotImplementedError

    def _pool_embeddings_impl(self, embeddings: List[Array], pool_factor: int, num_workers: Optional[int] = None):
        lens = [e.shape[0] for e in embeddings]
        if any(n == 1 for n in lens):
            raise ValueError("The input tensor must have more than one token.")
        padded = pad_sequences(embeddings)  # (B, L, D), right padding
        mask = np.zeros(padded.shape[:2], np.float32)
        for i, n in enumerate(lens):
            mask[i, :n] = 1.0
        # K must cover the longest document's cluster count
        factor = max(pool_factor, 1)
        t = padded.shape[1]
        most = max(max(n // factor, 1) for n in lens)
        if t // factor < most:
            padded = np.pad(padded, ((0, 0), (0, factor * most - t), (0, 0)))
            mask = np.pad(mask, ((0, 0), (0, factor * most - t)))
        pooled, cmask, assign = self._pool_padded(torch.from_numpy(np.ascontiguousarray(padded)).to(self.device),
                                                  torch.from_numpy(mask).to(self.device), factor)
        pooled, cmask, assign = (as_numpy(x) for x in (pooled, cmask, assign))

        out: List[Array] = []
        maps: List[Dict[int, Tuple[Array]]] = []
        for i, n in enumerate(lens):
            if pool_factor == 1:
                out.append(np.asarray(embeddings[i]))
                maps.append({0: (np.arange(n),)})
                continue
            kept = np.where(cmask[i])[0]
            out.append(pooled[i, kept])
            maps.append({new: (np.where(assign[i, :n] == orig)[0],) for new, orig in enumerate(kept)})
        return out, maps


class KMeansTokenPooler(_DevicePoolerBase):
    """:func:`kmeans_pool_padded` with the container API: the cheap device
    option, O(iters x T^2) a document against Ward's O(T^3). A document may
    pool to fewer than ``max(n // pool_factor, 1)`` rows (empty clusters are
    dropped), and it keeps less of MaxSim than Ward."""

    def __init__(self, iters: int = 10, device: Any = "cuda"):
        super().__init__(device)
        self.iters = iters

    def _pool_padded(self, padded, mask, pool_factor: int):
        return kmeans_pool_padded(padded, mask, pool_factor=pool_factor, iters=self.iters)


class DeviceWardTokenPooler(_DevicePoolerBase):
    """:func:`ward_pool_padded` with the container API: the partitions of
    :class:`HierarchicalTokenPooler` (scipy), clustered on the device."""

    def _pool_padded(self, padded, mask, pool_factor: int):
        return ward_pool_padded(padded, mask, pool_factor=pool_factor)


class LambdaTokenPooler(BaseTokenPooler):
    """Pool each 2-D embedding with a user function."""

    def __init__(self, pool_func: Callable[[Array], Array]):
        self.pool_func = pool_func

    def _pool_embeddings_impl(self, embeddings: List[Array], num_workers: Optional[int] = None):
        if num_workers and num_workers > 1:
            with ThreadPoolExecutor(num_workers) as ex:
                pooled = list(ex.map(self.pool_func, embeddings))
        else:
            pooled = [self.pool_func(e) for e in embeddings]
        return pooled, None
