"""Retrieval evaluation of the port (counterpart of :mod:`colpali_tpu.evaluation`)."""

from colpali_tpu_torch.evaluation.evaluator import embed_dataset, evaluate_retrieval  # noqa: F401
from colpali_tpu_torch.evaluation.metrics import mrr_at_k, ndcg_at_k, recall_at_k  # noqa: F401
