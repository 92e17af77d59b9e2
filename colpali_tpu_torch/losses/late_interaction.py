"""Late-interaction (ColBERT-style) contrastive losses (counterpart of
:mod:`colpali_tpu.losses.late_interaction`).

Each loss is a stateless callable on ``(B, Nq, D)`` query and ``(C, S, D)``
document embeddings; with documents gathered across data-parallel ranks the
positives of a rank sit at ``offset = rank * B`` in the gathered matrix.
Token similarities are one fp32 contraction reduced at once. The hard max
is ``amax`` (gradient split evenly over ties, as ``jnp.max``).
"""

from __future__ import annotations

import warnings

import torch

from colpali_tpu_torch.losses.common import (
    aggregate,
    apply_normalization,
    cross_entropy,
    filter_high_negatives,
    hardest_negative,
    hp_einsum,
    positive_indices,
    query_lengths,
    score_bounds,
    slice_rows,
    softplus,
)


class ColbertLossBase:
    """Hyperparameters shared by the late-interaction losses."""

    def __init__(
        self,
        temperature: float = 0.02,
        normalize_scores: bool = True,
        use_smooth_max: bool = False,
        pos_aware_negative_filtering: bool = False,
        tau: float = 0.1,
        norm_tol: float = 1e-3,
        filter_threshold: float = 0.95,
        filter_factor: float = 0.5,
        warn_out_of_bounds: bool = False,
    ):
        if temperature <= 0:
            raise ValueError("Temperature must be strictly positive")
        self.temperature = temperature
        self.normalize_scores = normalize_scores
        self.use_smooth_max = use_smooth_max
        self.pos_aware_negative_filtering = pos_aware_negative_filtering
        self.tau = tau
        self.norm_tol = norm_tol
        self.filter_threshold = filter_threshold
        self.filter_factor = filter_factor
        self.warn_out_of_bounds = warn_out_of_bounds
        self._bounds = None  # [min, max] of the normalized scores since the last flush_warnings, on their device

    def _shared_kwargs(self) -> dict:
        return dict(
            normalize_scores=self.normalize_scores,
            use_smooth_max=self.use_smooth_max,
            pos_aware_negative_filtering=self.pos_aware_negative_filtering,
            tau=self.tau,
            norm_tol=self.norm_tol,
            filter_threshold=self.filter_threshold,
            filter_factor=self.filter_factor,
        )

    def _full_scores(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor) -> torch.Tensor:
        """``(B, C)`` MaxSim scores of every query against every (gathered) doc."""
        raw = hp_einsum("bnd,csd->bcns", query_embeddings, doc_embeddings)
        return aggregate(raw, self.use_smooth_max, dim_max=3, dim_sum=2, tau=self.tau)

    def _maybe_normalize(self, scores: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if not self.normalize_scores:
            return scores
        normalized = apply_normalization(scores, lengths)
        if self.warn_out_of_bounds:
            self._bounds = score_bounds(normalized, self._bounds)
        return normalized

    def flush_warnings(self) -> None:
        """With ``warn_out_of_bounds``: warn if a normalized score since the
        last call left ``[-norm_tol, 1 + norm_tol]``. The calls themselves
        only keep a running min and max on the device; this reads them (one
        synchronization), so call it where the loop waits for the device
        anyway, as ``ColModelTraining`` does when it logs the loss."""
        if self._bounds is None:
            return
        (mn, mx), self._bounds = self._bounds.tolist(), None
        if mn < -self.norm_tol or mx > 1 + self.norm_tol:
            warnings.warn(f"Scores out of bounds after normalization: min={mn:.4f}, max={mx:.4f}", stacklevel=2)

    def _in_batch_scores(self, query_embeddings, doc_embeddings, offset: int):
        """Normalized, optionally filtered ``(B, C)`` scores and the index pair."""
        scores = self._maybe_normalize(self._full_scores(query_embeddings, doc_embeddings),
                                       query_lengths(query_embeddings))
        idx, pos_idx = positive_indices(scores.shape[0], offset, scores.device)
        if self.pos_aware_negative_filtering:
            scores = filter_high_negatives(scores, pos_idx, self.filter_threshold, self.filter_factor)
        return scores, idx, pos_idx

    def _explicit_scores(self, query_embeddings, doc_embeddings, neg_doc_embeddings, offset: int):
        """Normalized ``(B,)`` positive and ``(B, n_neg)`` explicit-negative scores."""
        lengths = query_lengths(query_embeddings)
        local_docs = slice_rows(doc_embeddings, offset, neg_doc_embeddings.shape[0])
        pos_raw = hp_einsum("bnd,bsd->bns", query_embeddings, local_docs)
        neg_raw = hp_einsum("bnd,blsd->blns", query_embeddings, neg_doc_embeddings)
        pos_scores = aggregate(pos_raw, self.use_smooth_max, dim_max=2, dim_sum=1, tau=self.tau)
        neg_scores = aggregate(neg_raw, self.use_smooth_max, dim_max=3, dim_sum=2, tau=self.tau)
        return self._maybe_normalize(pos_scores, lengths), self._maybe_normalize(neg_scores, lengths)


class ColbertLoss(ColbertLossBase):
    """In-batch InfoNCE over MaxSim scores."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores, _, pos_idx = self._in_batch_scores(query_embeddings, doc_embeddings, offset)
        return cross_entropy(scores / self.temperature, pos_idx)


class ColbertPairwiseCELoss(ColbertLossBase):
    """Softplus(hardest in-batch negative - positive)."""

    def __init__(self, temperature: float = 1.0, **kwargs):
        super().__init__(temperature=temperature, **kwargs)

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores, idx, pos_idx = self._in_batch_scores(query_embeddings, doc_embeddings, offset)
        pos_scores = scores[idx, pos_idx]
        neg_scores = hardest_negative(scores, pos_scores)
        return softplus((neg_scores - pos_scores) / self.temperature).mean()


class _WithExplicitNegatives(ColbertLossBase):
    """Softplus margin on explicit negatives, mixed with an in-batch term."""

    inner_cls: type

    def __init__(self, temperature: float = 0.02, in_batch_term_weight: float = 0.5, **kwargs):
        super().__init__(temperature=temperature, **kwargs)
        if not 0 <= in_batch_term_weight <= 1:
            raise ValueError("in_batch_term_weight must be in [0, 1]")
        self.in_batch_term_weight = in_batch_term_weight
        self.inner = self.inner_cls(temperature=temperature, **self._shared_kwargs())

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor,
                 neg_doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        pos_scores, neg_scores = self._explicit_scores(query_embeddings, doc_embeddings, neg_doc_embeddings, offset)
        loss = softplus((neg_scores - pos_scores[:, None]) / self.temperature).mean()
        if self.in_batch_term_weight > 0:
            loss_ib = self.inner(query_embeddings, doc_embeddings, offset)
            loss = loss * (1 - self.in_batch_term_weight) + loss_ib * self.in_batch_term_weight
        return loss


class ColbertNegativeCELoss(_WithExplicitNegatives):
    """Softplus margin on explicit negatives + optional in-batch InfoNCE term."""

    inner_cls = ColbertLoss


class ColbertPairwiseNegativeCELoss(_WithExplicitNegatives):
    """Pairwise softplus on explicit negatives + optional in-batch pairwise term."""

    inner_cls = ColbertPairwiseCELoss


class ColbertSigmoidLoss(ColbertLossBase):
    """Elementwise sigmoid (softplus) loss over the ``(B, C)`` score matrix:
    label +1 at column ``offset + i`` of row ``i``, -1 elsewhere."""

    def __call__(self, query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor, offset: int = 0) -> torch.Tensor:
        scores, _, pos_idx = self._in_batch_scores(query_embeddings, doc_embeddings, offset)
        col = torch.arange(scores.shape[1], device=scores.device)[None, :]
        labels = torch.where(col == pos_idx[:, None], 1.0, -1.0)
        return softplus(-(scores / self.temperature) * labels).mean()
