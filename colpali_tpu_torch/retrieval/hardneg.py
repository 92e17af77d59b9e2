"""Offline hard-negative mining (counterpart of
:mod:`colpali_tpu.retrieval.hardneg`): each query's top-k documents become
its ``negative_passages`` (the gold document left out), with the
``gold_in_top_100`` flag that dataset filters read.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from colpali_tpu_torch.ops.maxsim import score_multi_vector, score_single_vector
from colpali_tpu_torch.utils.tensor_utils import as_numpy, top_k

ArrayLike = Union[np.ndarray, torch.Tensor]


def _hosts(xs: Any) -> Any:
    """Arrays, or a list of arrays, on the host."""
    return [as_numpy(x) for x in xs] if isinstance(xs, (list, tuple)) else as_numpy(xs)


def mine_hard_negatives(
    query_embeddings: Union[ArrayLike, Sequence[ArrayLike]],
    doc_embeddings: Union[ArrayLike, Sequence[ArrayLike], None],
    gold_indices: Sequence[int],
    k: int = 100,
    multi_vector: bool = False,
    batch_size: int = 128,
    index: Optional[Any] = None,
) -> List[Dict[str, Any]]:
    """Top-``k`` mining over a corpus.

    ``query_embeddings`` and ``doc_embeddings`` are dense ``(n, D)`` or
    ragged multi-vector (``multi_vector=True``: MaxSim in place of the dot
    product). With ``index`` (a :class:`~colpali_tpu_torch.retrieval.CorpusIndex`)
    the queries go through its search, on its device, and the ``(Q, C)``
    score matrix is never made; ``doc_embeddings`` may then be None, and
    dense queries search an index of 1-token docs as 1-token queries.
    Otherwise the score matrix comes from :func:`score_single_vector` /
    :func:`score_multi_vector` and the top-k breaks ties toward the lower
    doc index, as ``lax.top_k`` does.

    Returns per query ``{"negative_passages", "gold_in_top_100",
    "top_scores"}``."""
    if index is not None:
        qs = [as_numpy(q) for q in query_embeddings] if multi_vector else [as_numpy(q)[None, :] for q in query_embeddings]
        k = min(k, index.num_docs)
        top_scores, top_idx = (np.asarray(x) for x in index.search(qs, k=k))
    else:
        qs, ds = _hosts(query_embeddings), _hosts(doc_embeddings)
        scores = score_multi_vector(qs, ds, batch_size=batch_size) if multi_vector else score_single_vector(qs, ds)
        k = min(k, scores.shape[1])
        top_scores, top_idx = (x.numpy() for x in top_k(torch.from_numpy(scores), k))

    out: List[Dict[str, Any]] = []
    for q, gold in enumerate(gold_indices):
        row = top_idx[q]
        out.append({"negative_passages": [int(i) for i in row if i != gold],
                    "gold_in_top_100": bool((row == gold).any()),
                    "top_scores": top_scores[q].tolist()})
    return out
