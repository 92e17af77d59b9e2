"""Plain MaxSim scoring: the oracle the kernels and the index are held to.

Counterpart of :mod:`colpali_tpu.ops.maxsim`: for every (query, doc) pair,
each query token takes its max similarity over doc tokens, summed over
query tokens. Zero-padded tokens score 0. :func:`score_single_vector` and
:func:`score_multi_vector` are the reference library's scoring API
(``processing_utils.py:103-187``); they take and return numpy arrays and
compute on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from colpali_tpu_torch.utils.tensor_utils import pad_sequences

ArrayLike = Union[np.ndarray, Sequence[np.ndarray]]


def maxsim(query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor) -> torch.Tensor:
    """``(B, Nq, D)`` x ``(C, Np, D)`` -> ``(B, C)`` fp32 MaxSim scores,
    as one ``(B*Nq, D) x (D, C*Np)`` fp32 matmul and a max/sum reduce."""
    b, nq, d = query_embeddings.shape
    c, np_, _ = doc_embeddings.shape
    sim = query_embeddings.reshape(b * nq, d).float() @ doc_embeddings.reshape(c * np_, d).float().T
    return sim.reshape(b, nq, c, np_).amax(dim=3).sum(dim=1)


def maxsim_pairwise(query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor) -> torch.Tensor:
    """Row-aligned MaxSim: query i against doc i only, ``(B, Nq, D)`` x
    ``(B, Np, D)`` -> ``(B,)`` fp32 (products and sums in fp32)."""
    sim = torch.einsum("bnd,bsd->bns", query_embeddings.float(), doc_embeddings.float())
    return sim.amax(dim=2).sum(dim=1)


def _as_list(xs: ArrayLike) -> List[np.ndarray]:
    if isinstance(xs, (list, tuple)):
        out = [np.asarray(x) for x in xs]
        if any(x.ndim != 2 for x in out):
            raise ValueError("Expected a list of 2D (seq, dim) arrays.")
        return out
    xs = np.asarray(xs)
    if xs.ndim == 2:
        return [xs]
    if xs.ndim == 3:
        return list(xs)
    raise ValueError("Expected a 3D array or a list of 2D arrays.")


def score_single_vector(qs: ArrayLike, ps: ArrayLike) -> np.ndarray:
    """Dot-product scores of single-vector (bi-encoder) embeddings ``(n_q, D)``
    and ``(n_p, D)`` (or lists of ``(D,)`` vectors) -> ``(n_q, n_p)`` float32."""
    def stacked(xs: ArrayLike, what: str) -> torch.Tensor:
        arr = np.stack([np.asarray(x) for x in xs]) if isinstance(xs, (list, tuple)) and xs else np.asarray(xs)
        if arr.shape[0] == 0:
            raise ValueError(f"No {what} provided")
        return torch.from_numpy(arr.astype(np.float32))

    return (stacked(qs, "queries") @ stacked(ps, "passages").T).numpy()


def score_multi_vector(
    qs: ArrayLike,
    ps: ArrayLike,
    batch_size: int = 128,
    token_pad_multiple: int = 16,
) -> np.ndarray:
    """MaxSim scores between ragged multi-vector queries and passages ->
    ``(n_queries, n_passages)`` float32 numpy array, computed on the CPU."""
    qs_list = _as_list(qs)
    ps_list = _as_list(ps)
    if not qs_list:
        raise ValueError("No queries provided")
    if not ps_list:
        raise ValueError("No passages provided")
    dim = qs_list[0].shape[1]
    for x in (*qs_list, *ps_list):
        if x.shape[1] != dim:
            raise ValueError(f"Embedding dim mismatch: expected {dim}, got {x.shape[1]}")

    nq = max(q.shape[0] for q in qs_list)
    np_len = max(p.shape[0] for p in ps_list)

    def block(xs, n):
        padded = pad_sequences(xs, pad_to=n, pad_multiple=token_pad_multiple)
        return torch.from_numpy(padded.astype(np.float32))

    rows = []
    for i in range(0, len(qs_list), batch_size):
        q_block = block(qs_list[i : i + batch_size], nq)
        cols = [
            maxsim(q_block, block(ps_list[j : j + batch_size], np_len)).numpy()
            for j in range(0, len(ps_list), batch_size)
        ]
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0).astype(np.float32)
