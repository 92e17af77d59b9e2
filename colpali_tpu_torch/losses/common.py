"""Shared building blocks of the contrastive losses (counterpart of
:mod:`colpali_tpu.losses.common`): plain functions on tensors, float32
throughout, differentiated by autograd. ``offset`` is a Python int: the
column of the first local positive in a gathered document matrix."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from colpali_tpu_torch.utils.tensor_utils import top_k


def hp_einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """Einsum in float32: operands are upcast first, so products and sums are
    fp32 whatever the model's dtype (the loss-side contractions are small)."""
    return torch.einsum(subscripts, *(op.float() for op in operands))


def smooth_max(scores: torch.Tensor, dim: int, tau: float) -> torch.Tensor:
    """Smooth max: temperature-scaled log-sum-exp."""
    return tau * torch.logsumexp(scores / tau, dim=dim)


def aggregate(raw: torch.Tensor, use_smooth_max: bool, dim_max: int, dim_sum: int, tau: float) -> torch.Tensor:
    """Token-level -> document-level scores: max (or smooth max) over doc
    tokens, then the sum over query tokens. ``dim_sum`` indexes the tensor
    after the first reduction. ``amax`` splits the gradient evenly over
    ties, as ``jnp.max`` does."""
    reduced = smooth_max(raw, dim_max, tau) if use_smooth_max else raw.amax(dim=dim_max)
    return reduced.sum(dim=dim_sum)


def query_lengths(query_embeddings: torch.Tensor) -> torch.Tensor:
    """Non-padding query tokens per row: a token counts iff the first
    component of its embedding is nonzero (padding vectors are all-zero)."""
    return (query_embeddings[:, :, 0] != 0).sum(dim=1)


def apply_normalization(scores: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Divide scores by the query length."""
    return scores / (lengths[:, None] if scores.ndim == 2 else lengths)


def score_bounds(normalized: torch.Tensor, previous: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[min, max]`` of ``normalized`` merged with ``previous``: two fp32
    numbers that stay on the scores' device, so keeping them costs no
    synchronization."""
    with torch.no_grad():
        bounds = torch.stack([normalized.min(), normalized.max()]).float()
        if previous is not None:
            bounds = torch.stack([torch.minimum(bounds[0], previous[0]), torch.maximum(bounds[1], previous[1])])
    return bounds


def filter_high_negatives(scores: torch.Tensor, pos_idx: torch.Tensor, filter_threshold: float,
                          filter_factor: float) -> torch.Tensor:
    """Down-weight negatives that score above a fraction of the positive:
    ``scores (B, C)``, ``pos_idx (B,)`` the positive column of each row."""
    pos_scores = scores.gather(1, pos_idx[:, None])  # (B, 1)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    mask = (scores > filter_threshold * pos_scores) & (col != pos_idx[:, None])
    return torch.where(mask, scores * filter_factor, scores)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    picked = logits.gather(1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def positive_indices(batch_size: int, offset: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, pos_idx)`` for in-batch losses."""
    idx = torch.arange(batch_size, device=device)
    return idx, idx + offset


def slice_rows(x: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """``x[offset : offset + size]``."""
    return x[offset : offset + size]


def hardest_negative(scores: torch.Tensor, pos_scores: torch.Tensor) -> torch.Tensor:
    """Per row, the best score that is not the positive's: the top score
    unless it equals the positive, then the runner-up. Ties go to the lower
    column, as ``jax.lax.top_k`` breaks them."""
    top2, _ = top_k(scores, 2)
    return torch.where(top2[:, 0] == pos_scores, top2[:, 1], top2[:, 0])
