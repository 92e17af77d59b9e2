"""Retrieval evaluation loop: embeddings -> index -> ranked lists -> metrics
(counterpart of :mod:`colpali_tpu.evaluation.evaluator`). Works from
precomputed embeddings or from a model and its processor."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from colpali_tpu_torch.data.prefetch import prefetch
from colpali_tpu_torch.evaluation.metrics import mrr_at_k, ndcg_at_k, recall_at_k
from colpali_tpu_torch.retrieval.store import CorpusIndex


def evaluate_retrieval(
    query_embeddings: Sequence[np.ndarray],
    doc_embeddings: Sequence[np.ndarray],
    relevance: Sequence[Any],
    k_values: Sequence[int] = (1, 5, 10, 100),
    index_dtype: str = "bf16",
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Score all queries against the corpus and compute ranked metrics.

    Args:
        query_embeddings / doc_embeddings: ragged multi-vector embeddings.
        relevance: per query, its gold doc ids (a list) or a ``{doc_id:
            gain}`` mapping.
        k_values: cutoffs; ndcg, recall and mrr are reported at each.
        device: where the index is built and searched.

    Returns ``{"ndcg@5": ..., "recall@10": ..., ...}`` averaged over queries.
    """
    index = CorpusIndex(doc_embeddings, dtype=index_dtype, device=device)
    return evaluate_retrieval_from_index(index, query_embeddings, relevance, k_values)


def evaluate_retrieval_from_index(
    index: CorpusIndex,
    query_embeddings: Sequence[np.ndarray],
    relevance: Sequence[Any],
    k_values: Sequence[int] = (1, 5, 10, 100),
) -> Dict[str, float]:
    """Ranked metrics against an index that is built already; callers that
    hold embeddings on the device build it with ``DeviceIndexBuilder``."""
    max_k = min(max(k_values), index.num_docs)
    _, ranked = index.search(query_embeddings, k=max_k)

    metrics: Dict[str, List[float]] = {}
    for q, rel in enumerate(relevance):
        for k in k_values:
            metrics.setdefault(f"ndcg@{k}", []).append(ndcg_at_k(ranked[q], rel, k))
            metrics.setdefault(f"recall@{k}", []).append(recall_at_k(ranked[q], rel, k))
            metrics.setdefault(f"mrr@{k}", []).append(mrr_at_k(ranked[q], rel, k))
    return {name: float(np.mean(vals)) for name, vals in metrics.items()}


@torch.no_grad()
def embed_dataset(
    model: torch.nn.Module,
    processor: Any,
    items: Sequence[Any],
    batch_size: int = 8,
    is_images: bool = True,
    use_query_prompt: bool = False,
    kind: Optional[str] = None,
) -> List[np.ndarray]:
    """Embed texts or images in batches; returns each item's embeddings
    without its padding, fp32.

    ``kind`` names the modality: ``"images"``, ``"texts"`` (raw
    ``process_texts``) or ``"queries"`` (``process_queries``: prefix and
    augmentation suffix); left out, it follows the two boolean flags.
    Preprocessing runs on a prefetch thread beside the device forward, and
    a processor whose ``process_images`` takes ``device_pixels`` keeps the
    pixels on its device. Every array of the processor's batch goes to the
    model as a keyword (the Qwen family's patch mask, grid positions,
    window ids and M-RoPE positions) but ``image_grid_thw``, which is
    metadata. The model runs on the device of its parameters."""
    if kind is None:
        kind = "images" if is_images else ("queries" if use_query_prompt else "texts")
    if kind not in ("images", "texts", "queries"):
        raise ValueError(f"unknown kind {kind!r} (images, texts or queries)")
    device = next(model.parameters()).device
    device_pixels = kind == "images" and "device_pixels" in inspect.signature(processor.process_images).parameters

    def produce():
        for i in range(0, len(items), batch_size):
            chunk = list(items[i : i + batch_size])
            if kind == "images":
                yield processor.process_images(chunk, device_pixels=True) if device_pixels \
                    else processor.process_images(chunk)
            elif kind == "queries":
                yield processor.process_queries(queries=chunk)
            else:
                yield processor.process_texts(chunk)

    was_training = model.training
    model.eval()
    out: List[np.ndarray] = []
    for batch in prefetch(produce(), buffer_size=2):
        inputs = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "image_grid_thw"}
        inputs["input_ids"] = inputs["input_ids"].long()
        emb = model(**inputs).float().cpu().numpy()
        valid = np.asarray(batch["attention_mask"]).astype(bool)
        out.extend(emb[row][valid[row]] for row in range(emb.shape[0]))
    model.train(was_training)
    return out
