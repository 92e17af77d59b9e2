"""Retrieval metrics: nDCG@k / Recall@k / MRR@k (the port's copy of
:mod:`colpali_tpu.evaluation.metrics`, pure numpy), so that the eval loop
runs on the package's own outputs."""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np

Relevance = Union[Mapping[int, float], Sequence[int]]


def _gains(ranked_ids: np.ndarray, relevance: Relevance) -> np.ndarray:
    if isinstance(relevance, Mapping):
        return np.asarray([float(relevance.get(int(d), 0.0)) for d in ranked_ids])
    gold = set(int(g) for g in relevance)
    return np.asarray([1.0 if int(d) in gold else 0.0 for d in ranked_ids])


def ndcg_at_k(ranked_ids: Sequence[int], relevance: Relevance, k: int = 5) -> float:
    """Normalized discounted cumulative gain (exponential gains, log2
    discounts — the ViDoRe/BEIR convention)."""
    ranked = np.asarray(ranked_ids)[:k]
    gains = _gains(ranked, relevance)
    discounts = 1.0 / np.log2(np.arange(2, gains.size + 2))
    dcg = float(np.sum((2.0**gains - 1.0) * discounts))

    if isinstance(relevance, Mapping):
        ideal = np.sort(np.asarray([float(v) for v in relevance.values()]))[::-1][:k]
    else:
        ideal = np.ones(min(len(set(relevance)), k))
    if ideal.size == 0:
        return 0.0
    idiscounts = 1.0 / np.log2(np.arange(2, ideal.size + 2))
    idcg = float(np.sum((2.0**ideal - 1.0) * idiscounts))
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(ranked_ids: Sequence[int], relevance: Relevance, k: int = 5) -> float:
    ranked = set(int(d) for d in np.asarray(ranked_ids)[:k])
    gold = (
        set(int(d) for d, v in relevance.items() if v > 0)
        if isinstance(relevance, Mapping)
        else set(int(g) for g in relevance)
    )
    if not gold:
        return 0.0
    return len(ranked & gold) / len(gold)


def mrr_at_k(ranked_ids: Sequence[int], relevance: Relevance, k: int = 10) -> float:
    gold = (
        set(int(d) for d, v in relevance.items() if v > 0)
        if isinstance(relevance, Mapping)
        else set(int(g) for g in relevance)
    )
    for rank, d in enumerate(np.asarray(ranked_ids)[:k], start=1):
        if int(d) in gold:
            return 1.0 / rank
    return 0.0
