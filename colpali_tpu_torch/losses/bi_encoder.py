"""Bi-encoder (single-vector) contrastive losses (counterpart of
:mod:`colpali_tpu.losses.bi_encoder`): the same conventions as
:mod:`colpali_tpu_torch.losses.late_interaction` on ``(B, D)`` query and
``(C, D)`` document embeddings."""

from __future__ import annotations

import torch

from colpali_tpu_torch.losses.common import (
    cross_entropy,
    filter_high_negatives,
    hardest_negative,
    hp_einsum,
    positive_indices,
    slice_rows,
    softplus,
)


def _dense_scores(query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor) -> torch.Tensor:
    """``(B, C)`` dot-product similarity matrix in fp32."""
    return hp_einsum("bd,cd->bc", query_embeddings, doc_embeddings)


class BiEncoderLossBase:
    """Hyperparameters shared by the bi-encoder losses."""

    def __init__(self, temperature: float = 0.02, pos_aware_negative_filtering: bool = False,
                 filter_threshold: float = 0.95, filter_factor: float = 0.5):
        if temperature <= 0:
            raise ValueError("Temperature must be strictly positive")
        self.temperature = temperature
        self.pos_aware_negative_filtering = pos_aware_negative_filtering
        self.filter_threshold = filter_threshold
        self.filter_factor = filter_factor

    def _maybe_filter(self, scores: torch.Tensor, pos_idx: torch.Tensor) -> torch.Tensor:
        if self.pos_aware_negative_filtering:
            return filter_high_negatives(scores, pos_idx, self.filter_threshold, self.filter_factor)
        return scores


class BiEncoderLoss(BiEncoderLossBase):
    """In-batch InfoNCE."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores = _dense_scores(query_embeddings, doc_embeddings)
        _, pos_idx = positive_indices(scores.shape[0], offset, scores.device)
        return cross_entropy(self._maybe_filter(scores, pos_idx) / self.temperature, pos_idx)


class BiPairedEncoderLoss(BiEncoderLossBase):
    """Symmetric query<->doc InfoNCE. The doc->query direction uses the local
    identity labels, which matches gathered docs only when ``C == B``."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores = _dense_scores(query_embeddings, doc_embeddings)
        idx, pos_idx = positive_indices(scores.shape[0], offset, scores.device)
        scores = self._maybe_filter(scores, pos_idx)
        q2t = cross_entropy(scores / self.temperature, pos_idx)
        t2q = cross_entropy(scores.T / self.temperature, idx)
        return (q2t + t2q) / 2.0


class BiPairwiseCELoss(BiEncoderLossBase):
    """Softplus(hardest in-batch negative - positive). The positives are the
    local diagonal and the filter uses identity indices: ``offset`` is
    accepted and unused, as in the JAX package."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores = _dense_scores(query_embeddings, doc_embeddings)
        idx = torch.arange(scores.shape[0], device=scores.device)
        pos_scores = scores[idx, idx]
        neg_scores = hardest_negative(self._maybe_filter(scores, idx), pos_scores)
        return softplus((neg_scores - pos_scores) / self.temperature).mean()


class _BiWithExplicitNegatives(BiEncoderLossBase):
    def __init__(self, temperature: float = 0.02, in_batch_term_weight: float = 0.5, **kwargs):
        super().__init__(temperature=temperature, **kwargs)
        if not 0 <= in_batch_term_weight <= 1:
            raise ValueError("in_batch_term_weight must be in [0, 1]")
        self.in_batch_term_weight = in_batch_term_weight

    def _mix(self, loss, query_embeddings, doc_embeddings, offset):
        if self.in_batch_term_weight > 0:
            loss_ib = self.inner(query_embeddings, doc_embeddings, offset)
            loss = loss * (1 - self.in_batch_term_weight) + loss_ib * self.in_batch_term_weight
        return loss


class BiNegativeCELoss(_BiWithExplicitNegatives):
    """Softplus margin on explicit negatives + optional in-batch InfoNCE."""

    def __init__(self, temperature: float = 0.02, in_batch_term_weight: float = 0.5, **kwargs):
        super().__init__(temperature, in_batch_term_weight, **kwargs)
        self.inner = BiEncoderLoss(
            temperature=temperature, pos_aware_negative_filtering=self.pos_aware_negative_filtering,
            filter_threshold=self.filter_threshold, filter_factor=self.filter_factor)

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor,
                 neg_doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        local_docs = slice_rows(doc_embeddings, offset, neg_doc_embeddings.shape[0])
        pos_scores = (query_embeddings.float() * local_docs.float()).sum(dim=1) / self.temperature
        neg_scores = hp_einsum("bd,bnd->bn", query_embeddings, neg_doc_embeddings) / self.temperature
        loss = softplus(neg_scores - pos_scores[:, None]).mean()
        return self._mix(loss, query_embeddings, doc_embeddings, offset)


class BiPairwiseNegativeCELoss(_BiWithExplicitNegatives):
    """Pairwise softplus on explicit negatives + optional in-batch pairwise
    term (whose own filtering is off, as in the JAX package)."""

    def __init__(self, temperature: float = 0.02, in_batch_term_weight: float = 0.5, **kwargs):
        super().__init__(temperature, in_batch_term_weight, **kwargs)
        self.inner = BiPairwiseCELoss(
            temperature=temperature, pos_aware_negative_filtering=False,
            filter_threshold=self.filter_threshold, filter_factor=self.filter_factor)

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor,
                 neg_doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        local_docs = slice_rows(doc_embeddings, offset, query_embeddings.shape[0])
        pos = (query_embeddings.float() * local_docs.float()).sum(dim=1)
        neg = (query_embeddings.float()[:, None, :] * neg_doc_embeddings.float()).sum(dim=2)
        loss = softplus((neg - pos[:, None]) / self.temperature).mean()
        return self._mix(loss, query_embeddings, doc_embeddings, offset)


class BiSigmoidLoss(BiEncoderLossBase):
    """Elementwise sigmoid (softplus) loss over the ``(B, C)`` score matrix:
    label +1 at column ``offset + i`` of row ``i``, -1 elsewhere, averaged
    over all ``B * C`` elements."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores = _dense_scores(query_embeddings, doc_embeddings)
        _, pos_idx = positive_indices(scores.shape[0], offset, scores.device)
        scores = self._maybe_filter(scores, pos_idx)
        col = torch.arange(scores.shape[1], device=scores.device)[None, :]
        labels = torch.where(col == pos_idx[:, None], 1.0, -1.0)
        return softplus(-(scores / self.temperature) * labels).mean()
