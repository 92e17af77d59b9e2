"""Similarity maps: each query token's similarity to every image patch
(counterpart of :mod:`colpali_tpu.interpretability.similarity_maps`).

- :func:`get_similarity_maps_from_embeddings`: the image tokens picked by a
  mask, laid out ``(h w) c -> w h c``, against the query tokens.
- :func:`normalize_similarity_map`: min-max to [0, 1].
- :func:`upsample_similarity_map`: a map resized to the page as
  ``jax.image.resize(..., "bicubic", antialias=False)`` resizes it (Keys'
  cubic at -0.5, half-pixel centres; ``F.interpolate``'s is -0.75).
- :func:`plot_similarity_map` / :func:`plot_all_similarity_maps`: the heat
  map over the page (matplotlib, imported when called).

Inputs may be numpy arrays or tensors; the maps are numpy arrays.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.processors.image_processing import resize_float
from colpali_tpu_torch.utils.tensor_utils import as_numpy

EPSILON = 1e-10


def get_similarity_maps_from_embeddings(
    image_embeddings: Any,
    query_embeddings: Any,
    n_patches: Union[Tuple[int, int], List[Tuple[int, int]]],
    image_mask: Any,
) -> List[np.ndarray]:
    """``image_embeddings (B, S, dim)``, ``query_embeddings (B, Nq, dim)``,
    ``n_patches`` (n_patches_x, n_patches_y) per image (or one tuple for
    all) and ``image_mask (B, S)`` (the image tokens) -> a list of ``(Nq,
    n_patches_x, n_patches_y)`` maps."""
    image_embeddings = as_numpy(image_embeddings)
    query_embeddings = as_numpy(query_embeddings)
    image_mask = as_numpy(image_mask).astype(bool)
    if isinstance(n_patches, tuple):
        n_patches = [n_patches] * image_embeddings.shape[0]

    maps: List[np.ndarray] = []
    for idx in range(image_embeddings.shape[0]):
        npx, npy = n_patches[idx]
        n_img = int(image_mask[idx].sum())
        if n_img != npx * npy:
            raise ValueError(
                f"The number of patches ({npx} x {npy} = {npx * npy}) does not match "
                f"the number of non-padded image tokens ({n_img})."
            )
        tokens = image_embeddings[idx][image_mask[idx]]  # row-major (h, w)
        grid = tokens.reshape(npy, npx, -1).transpose(1, 0, 2)  # "(h w) c -> w h c"
        maps.append(np.einsum("nk,ijk->nij", query_embeddings[idx], grid))
    return maps


def normalize_similarity_map(similarity_map: Any, value_range: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Min-max normalize to [0, 1] over the last two dims (or over ``value_range``)."""
    similarity_map = as_numpy(similarity_map)
    if similarity_map.ndim not in (2, 3):
        raise ValueError(
            "The input tensor must have 2 dimensions (n_patch_x, n_patch_y) or "
            "3 dimensions (batch_size, n_patch_x, n_patch_y)."
        )
    if value_range is None:
        mins = similarity_map.min(axis=(-2, -1), keepdims=True)
        maxs = similarity_map.max(axis=(-2, -1), keepdims=True)
    else:
        mins = np.asarray(value_range[0], similarity_map.dtype)
        maxs = np.asarray(value_range[1], similarity_map.dtype)
    return (similarity_map - mins) / (maxs - mins + EPSILON)


def upsample_similarity_map(similarity_map: Any, height: int, width: int) -> np.ndarray:
    """One ``(n_patches_x, n_patches_y)`` map, normalized, as a ``(height,
    width)`` heat map in [0, 1] (the map is (x, y): transposed for display)."""
    sim = normalize_similarity_map(np.asarray(as_numpy(similarity_map), np.float32))
    x = torch.from_numpy(np.ascontiguousarray(sim.T))[None, :, :, None]
    heat = resize_float(x, height, width, method="bicubic", antialias=False)[0, :, :, 0].numpy()
    return np.clip(heat, 0.0, 1.0)


def plot_similarity_map(image, similarity_map: Any, figsize: Tuple[int, int] = (8, 8), show_colorbar: bool = False):
    """One token's heat map over the page image. Returns ``(fig, ax)``;
    needs matplotlib."""
    import matplotlib.pyplot as plt

    img = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
    heat = upsample_similarity_map(similarity_map, *img.shape[:2])
    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(img)
    im = ax.imshow(heat, alpha=0.5, cmap="viridis", vmin=0.0, vmax=1.0)
    if show_colorbar:
        fig.colorbar(im, ax=ax)
    ax.axis("off")
    return fig, ax


def plot_all_similarity_maps(
    image,
    query_tokens: List[str],
    similarity_maps: Any,
    figsize: Tuple[int, int] = (8, 8),
    show_colorbar: bool = False,
    add_title: bool = True,
):
    """One figure per query token; returns a list of ``(fig, ax)``."""
    plots = []
    for idx, token in enumerate(query_tokens):
        fig, ax = plot_similarity_map(image, similarity_maps[idx], figsize, show_colorbar)
        if add_title:
            score = float(as_numpy(similarity_maps[idx]).max())
            ax.set_title(f"Token #{idx}: `{token}`. MaxSim score: {score:.2f}", fontsize=12)
        plots.append((fig, ax))
    return plots
