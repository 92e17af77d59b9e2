"""Padding helpers for variable-length multi-vector embeddings (numpy) and
the port's top-k.

Counterpart of :mod:`colpali_tpu.utils.tensor_utils`: padded rows are
all-zero vectors, which MaxSim scores as 0.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, int32 indices)`` of the ``k`` largest along the last axis,
    ties broken toward the lower index (``jax.lax.top_k`` semantics). The
    values carry gradients back to the entries they were taken from."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def as_numpy(x) -> np.ndarray:
    """A numpy array of an array or a tensor on any device (bf16, which
    numpy lacks, widened to fp32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((x + multiple - 1) // multiple) * multiple


def pad_sequences(
    sequences: Sequence[np.ndarray],
    pad_value: float = 0.0,
    pad_to: int | None = None,
    pad_multiple: int = 1,
    padding_side: str = "right",
) -> np.ndarray:
    """Stack variable-length ``(len_i, dim)`` arrays into ``(batch, max_len, dim)``.

    ``pad_to`` sets the target length (at least the longest sequence);
    ``pad_multiple`` rounds it up to a multiple.
    """
    if len(sequences) == 0:
        raise ValueError("No sequences provided")
    if padding_side not in ("left", "right"):
        raise ValueError("padding_side must be either 'left' or 'right'.")

    seqs = [np.asarray(s) for s in sequences]
    max_len = max(s.shape[0] for s in seqs)
    target = pad_to if pad_to is not None else max_len
    if target < max_len:
        raise ValueError(f"pad_to={target} is smaller than longest sequence ({max_len})")
    target = round_up(target, pad_multiple)

    trailing = seqs[0].shape[1:]
    out = np.full((len(seqs), target, *trailing), pad_value, dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        if padding_side == "right":
            out[i, : s.shape[0]] = s
        else:
            out[i, target - s.shape[0] :] = s
    return out


def unbind_padded_multivector_embeddings(
    embeddings: np.ndarray,
    padding_value: float = 0.0,
    padding_side: str = "left",
) -> List[np.ndarray]:
    """Split a padded ``(batch, seq, dim)`` batch back into ragged 2D arrays.

    A position is padding iff every component equals ``padding_value``. With
    left padding everything before the first non-padding row is dropped,
    with right padding everything after the last one; padding-valued rows
    inside a sequence stay."""
    embeddings = np.asarray(embeddings)
    if embeddings.ndim != 3:
        raise ValueError("The input must be a 3D array (batch, seq, dim).")
    if padding_side not in ("left", "right"):
        raise ValueError("padding_side must be either 'left' or 'right'.")
    results: List[np.ndarray] = []
    for seq in embeddings:
        idx = np.nonzero(~np.all(seq == padding_value, axis=-1))[0]
        if idx.size == 0:
            results.append(seq[:0])
        elif padding_side == "left":
            results.append(seq[idx[0] :])
        else:
            results.append(seq[: idx[-1] + 1])
    return results
