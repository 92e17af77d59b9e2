"""Port parity: similarity maps (colpali_tpu_torch.interpretability) against
colpali_tpu.interpretability.

Seeded numpy embeddings on the CPU. Maps are fp32 einsums on both sides:
atol 1e-6. The upsampled heat map is held to ``jax.image.resize(...,
"bicubic", antialias=False)`` at 1e-5. Split-image maps take their mask
from the port's ``ColIdefics3Processor.get_local_image_mask`` over pages
split into 64 px tiles of 2 x 2 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu import interpretability as jinterp
from colpali_tpu_torch.interpretability import (
    get_similarity_maps_from_embeddings,
    get_split_image_similarity_maps,
    normalize_similarity_map,
    plot_all_similarity_maps,
    plot_similarity_map,
    rearrange_image_embeddings,
)
from colpali_tpu_torch.interpretability.similarity_maps import upsample_similarity_map

ATOL = 1e-6


def _batch(seed, npx=4, npy=3, extra=5, dim=16, nq=6, b=2):
    rng = np.random.default_rng(seed)
    s = npx * npy + extra
    image = rng.normal(size=(b, s, dim)).astype(np.float32)
    query = rng.normal(size=(b, nq, dim)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, 2 : 2 + npx * npy] = True
    return image, query, mask


def test_similarity_maps_match_jax():
    image, query, mask = _batch(0)
    got = get_similarity_maps_from_embeddings(image, query, (4, 3), mask)
    want = jinterp.get_similarity_maps_from_embeddings(image, query, (4, 3), mask)
    assert [m.shape for m in got] == [(6, 4, 3)] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    # tensors in, the same maps; one n_patches a page
    again = get_similarity_maps_from_embeddings(torch.from_numpy(image), torch.from_numpy(query), [(4, 3), (4, 3)],
                                                torch.from_numpy(mask))
    for g, w in zip(again, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    # against the definition: map[n, x, y] = <q_n, token at row y, column x>
    tokens = image[1][mask[1]].reshape(3, 4, -1)
    np.testing.assert_allclose(got[1][2, 3, 1], query[1, 2] @ tokens[1, 3], atol=ATOL)
    with pytest.raises(ValueError, match=r"does not match the number of non-padded image tokens \(12\)"):
        get_similarity_maps_from_embeddings(image, query, (5, 3), mask)


def test_normalize_matches_jax():
    rng = np.random.default_rng(1)
    for shape in ((4, 3), (2, 4, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        got = normalize_similarity_map(x)
        np.testing.assert_allclose(got, jinterp.normalize_similarity_map(x), atol=ATOL)
        assert got.min() >= 0.0 and got.max() <= 1.0 and np.isclose(got.max(), 1.0, atol=1e-6)
        np.testing.assert_allclose(normalize_similarity_map(x, value_range=(-3.0, 3.0)),
                                   jinterp.normalize_similarity_map(x, value_range=(-3.0, 3.0)), atol=ATOL)
    with pytest.raises(ValueError, match="must have 2 dimensions"):
        normalize_similarity_map(np.zeros(3))


@pytest.mark.parametrize("hw", [(37, 29), (8, 6), (4, 3)])
def test_upsampled_heat_map_matches_jax_resize(hw):
    sim = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)  # (n_patches_x, n_patches_y)
    want = np.clip(np.asarray(jax.image.resize(jnp.asarray(jinterp.normalize_similarity_map(sim).T), hw,
                                               method="bicubic", antialias=False)), 0.0, 1.0)
    got = upsample_similarity_map(sim, *hw)
    assert got.shape == hw
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_plots_return_figures():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image, query, mask = _batch(3)
    maps = get_similarity_maps_from_embeddings(image, query, (4, 3), mask)
    page = np.random.default_rng(3).integers(0, 256, size=(30, 40, 3), dtype=np.uint8)
    fig, ax = plot_similarity_map(page, maps[0][0], show_colorbar=True)
    assert isinstance(fig, plt.Figure) and ax.images[1].get_array().shape == (30, 40)
    plots = plot_all_similarity_maps(page, ["a", "b"], maps[0][:2])
    assert len(plots) == 2 and plots[1][1].get_title().startswith("Token #1: `b`. MaxSim score:")
    plt.close("all")


@pytest.fixture(scope="module")
def tiled():
    """Two pages split into 64 px tiles of 2 x 2 tokens (3 x 2 and 1 x 2
    tiles, each with its global view) and random embeddings of their
    prompts."""
    from colpali_tpu_torch.processors.idefics3 import ColIdefics3Processor
    from colpali_tpu_torch.utils.testing import idefics3_word_tokenizer

    proc = ColIdefics3Processor(idefics3_word_tokenizer(["Describe", "the", "image."]), tile_size=64,
                                longest_edge=256, image_seq_len=4, device="cpu")
    rng = np.random.default_rng(4)
    pages = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in ((180, 120), (60, 120))]
    batch = proc.process_images(pages)
    s = batch["input_ids"].shape[1]
    image = rng.normal(size=(2, s, 8)).astype(np.float32)
    query = rng.normal(size=(2, 5, 8)).astype(np.float32)
    return proc, pages, batch, image, query


def test_split_image_maps_match_jax(tiled):
    proc, pages, batch, image, query = tiled
    mask = proc.get_local_image_mask(batch)
    n_patches = [proc.get_n_patches(p.shape[:2]) for p in pages]
    assert n_patches == [(4, 6), (4, 2)] and mask.sum(axis=1).tolist() == [24, 8]
    got = get_split_image_similarity_maps(image, query, n_patches, mask, proc.image_seq_len)
    want = jinterp.get_split_image_similarity_maps(image, query, n_patches, mask, proc.image_seq_len)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    grid = rearrange_image_embeddings(image[0], mask[0], n_patches[0], proc.image_seq_len)
    np.testing.assert_array_equal(grid, jinterp.rearrange_image_embeddings(image[0], mask[0], n_patches[0],
                                                                           proc.image_seq_len))
    # the first tile's second row, second token sits at x = 1, y = 1 of the page grid
    np.testing.assert_array_equal(grid[1, 1], image[0][mask[0]][3])
    with pytest.raises(ValueError, match="get_local_image_mask"):
        get_split_image_similarity_maps(image, query, n_patches, proc.get_image_mask(batch), proc.image_seq_len)
