"""Similarity maps of split images (counterpart of
:mod:`colpali_tpu.interpretability.split_image`): Idefics3's tokens arrive
tile by tile, each tile a ``k x k`` grid, and are laid out on the page's
grid before the similarity product.
"""

from __future__ import annotations

import math
from typing import Any, List, Tuple, Union

import numpy as np

from colpali_tpu_torch.utils.tensor_utils import as_numpy


def rearrange_image_embeddings(
    image_embeddings: Any,
    image_mask: Any,
    n_patches: Tuple[int, int],
    image_seq_len: int,
) -> np.ndarray:
    """``(S, dim)`` tokens and their mask -> the ``(n_patches_x,
    n_patches_y, dim)`` grid: tiles of ``k = sqrt(image_seq_len)`` tokens a
    side, row-major over the page."""
    masked = as_numpy(image_embeddings)[as_numpy(image_mask).astype(bool)]
    npx, npy = n_patches
    dim = masked.shape[-1]
    k = int(math.sqrt(image_seq_len))
    grid = masked.reshape(npy // k, npx // k, k, k, dim)
    grid = grid.transpose(0, 2, 1, 3, 4)  # tile rows interleaved with token rows
    grid = grid.reshape(npy, npx, dim)
    return grid.transpose(1, 0, 2)  # (x, y, dim), the maps' order


def get_split_image_similarity_maps(
    image_embeddings: Any,
    query_embeddings: Any,
    n_patches: Union[Tuple[int, int], List[Tuple[int, int]]],
    image_mask: Any,
    image_seq_len: int,
) -> List[np.ndarray]:
    """Similarity maps with the tiles in place; ``image_mask`` leaves the
    global tile out (the processor's ``get_local_image_mask``)."""
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
                f"The number of patches ({npx} x {npy} = {npx * npy}) does not match the number of "
                f"non-padded image tokens ({n_img}). "
                "Hint: Use get_local_image_mask() instead of get_image_mask() to exclude the global patch."
            )
        grid = rearrange_image_embeddings(image_embeddings[idx], image_mask[idx], (npx, npy), image_seq_len)
        maps.append(np.einsum("nk,ijk->nij", query_embeddings[idx], grid))
    return maps
