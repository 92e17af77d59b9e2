"""Port parity: the scoring API around the kernels. ``maxsim_pairwise``,
``score_single_vector`` and ``unbind_padded_multivector_embeddings``, and
``BaseVisualRetrieverProcessor.score*``, against colpali_tpu on the same
numpy inputs.

Tolerance: rtol=1e-5, atol=1e-5 (fp32 products and sums in another order);
the ragged split is compared exactly.
"""

import importlib

import numpy as np
import pytest
import torch

from colpali_tpu.processors.base import BaseVisualRetrieverProcessor as JaxProcessor
from colpali_tpu.utils.tensor_utils import unbind_padded_multivector_embeddings as jax_unbind
from colpali_tpu_torch import ops as tops
from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor as TorchProcessor
from colpali_tpu_torch.utils.tensor_utils import unbind_padded_multivector_embeddings

RTOL, ATOL = 1e-5, 1e-5
jm = importlib.import_module("colpali_tpu.ops.maxsim")  # the package re-exports a function of that name


def test_ops_exports_match_jax():
    import colpali_tpu.ops as jops

    names = {n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))}
    assert names <= {n for n in dir(tops) if callable(getattr(tops, n))}


def test_maxsim_pairwise_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 5, 32)).astype(np.float32)
    d = rng.normal(size=(3, 9, 32)).astype(np.float32)
    q[:, -1] = 0.0
    got = tops.maxsim_pairwise(torch.from_numpy(q), torch.from_numpy(d))
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.maxsim_pairwise(q, d)), rtol=RTOL, atol=ATOL)
    # the diagonal of the all-pairs scores
    np.testing.assert_allclose(got.numpy(), np.diag(tops.maxsim(torch.from_numpy(q), torch.from_numpy(d)).numpy()),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("as_list", [False, True])
def test_score_single_vector_matches_jax(as_list):
    rng = np.random.default_rng(1)
    qs, ps = rng.normal(size=(4, 16)), rng.normal(size=(6, 16))  # float64 in, float32 out on both sides
    if as_list:
        qs, ps = list(qs), list(ps)
    got = tops.score_single_vector(qs, ps)
    want = jm.score_single_vector(qs, ps)
    assert got.shape == (4, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for empty in ([], np.zeros((0, 16))):
        with pytest.raises(ValueError, match="No queries"):
            tops.score_single_vector(empty, ps)


@pytest.mark.parametrize("side", ["left", "right"])
def test_unbind_matches_jax(side):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 3)).astype(np.float32)
    if side == "left":
        x[0, :3] = 0.0
    else:
        x[0, 5:] = 0.0
    x[1, 3] = 0.0  # an all-zero row inside a sequence stays
    x[2] = 0.0  # all padding
    got, want = unbind_padded_multivector_embeddings(x, padding_side=side), jax_unbind(x, padding_side=side)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape == (0, 3) and got[1].shape == (7, 3)
    with pytest.raises(ValueError, match="3D"):
        unbind_padded_multivector_embeddings(x[0])
    with pytest.raises(ValueError, match="padding_side"):
        unbind_padded_multivector_embeddings(x, padding_side="top")


class _TorchProcessor(TorchProcessor):
    def process_images(self, images):
        raise NotImplementedError

    def process_texts(self, texts):
        raise NotImplementedError

    def get_n_patches(self, image_size, *args, **kwargs):
        raise NotImplementedError


class _JaxProcessor(JaxProcessor):
    def process_images(self, images):
        raise NotImplementedError

    def process_texts(self, texts):
        raise NotImplementedError

    def get_n_patches(self, image_size, *args, **kwargs):
        raise NotImplementedError


def test_processor_scoring_matches_jax():
    rng = np.random.default_rng(3)
    qs = [rng.normal(size=(n, 16)).astype(np.float32) for n in (3, 7, 5)]
    ps = [rng.normal(size=(n, 16)).astype(np.float32) for n in (9, 2, 12, 4)]
    ours, theirs = _TorchProcessor(), _JaxProcessor()
    for got, want in ((ours.score(qs, ps), theirs.score(qs, ps)),
                      (ours.score_multi_vector(qs, ps, batch_size=2), theirs.score_multi_vector(qs, ps, batch_size=2)),
                      (ours.score_single_vector([q[0] for q in qs], [p[0] for p in ps]),
                       theirs.score_single_vector([q[0] for q in qs], [p[0] for p in ps]))):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert ours.score(qs, ps).shape == (3, 4)
