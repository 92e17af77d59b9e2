"""Port parity: every loss of colpali_tpu_torch.losses against its
colpali_tpu counterpart, value and gradients, on the same numpy inputs.

Tolerance: values rtol=1e-5; gradients rtol=1e-5 plus atol=5e-6 (fp32 on
both sides, contractions summed in another order; a gradient entry is
1/temperature = 50 times a difference of softmax terms of order 1, so where
the positive's probability nears 1 it is a small remainder and XLA's
approximate CPU exp leaves about 2e-6 absolute). Covered: offsets into a
gathered document matrix, explicit negatives, the smooth max, score
normalization, positive-aware negative filtering, and a tie between the two
best scores of a row (both sides take the lower column first).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu import losses as jl
from colpali_tpu_torch import losses as tl

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 5e-6


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _multi(seed=0, b=4, c=4, nq=5, s=7, n_neg=2, d=16):
    rng = np.random.default_rng(seed)
    q = _unit(rng, b, nq, d)
    q[1, 3:] = 0.0  # padded query tokens
    q[3, 4:] = 0.0
    return q, _unit(rng, c, s, d), _unit(rng, b, n_neg, s, d)


def _single(seed=0, b=4, c=4, n_neg=2, d=16):
    rng = np.random.default_rng(seed)
    return _unit(rng, b, d), _unit(rng, c, d), _unit(rng, b, n_neg, d)


def _compare(jloss, tloss, arrays, offset):
    n = len(arrays)
    want, want_grads = jax.jit(jax.value_and_grad(lambda *a: jloss(*a, offset=offset), argnums=tuple(range(n))))(
        *(jnp.asarray(a) for a in arrays))
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tloss(*tensors, offset=offset)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    for t, g in zip(tensors, want_grads):
        grad = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(g), rtol=RTOL, atol=GRAD_ATOL)


LATE = [
    ("ColbertLoss", {}, False),
    ("ColbertLoss", {"use_smooth_max": True, "tau": 0.3}, False),
    ("ColbertLoss", {"normalize_scores": False, "temperature": 0.5}, False),
    ("ColbertLoss", {"pos_aware_negative_filtering": True, "filter_threshold": 0.2}, False),
    ("ColbertPairwiseCELoss", {}, False),
    ("ColbertPairwiseCELoss", {"pos_aware_negative_filtering": True, "filter_threshold": 0.2, "temperature": 0.1},
     False),
    ("ColbertSigmoidLoss", {}, False),
    ("ColbertNegativeCELoss", {}, True),
    ("ColbertNegativeCELoss", {"in_batch_term_weight": 0.0, "use_smooth_max": True}, True),
    ("ColbertPairwiseNegativeCELoss", {}, True),
    ("ColbertPairwiseNegativeCELoss", {"in_batch_term_weight": 1.0, "normalize_scores": False}, True),
]


@pytest.mark.parametrize("case", range(len(LATE)))
def test_late_interaction_loss_matches_jax(case):
    name, kwargs, negatives = LATE[case]
    offset = 2 * (case % 2)  # every other case takes its positives from a gathered matrix
    q, d, n = _multi(seed=case, c=4 + offset)
    arrays = (q, d, n) if negatives else (q, d)
    _compare(getattr(jl, name)(**kwargs), getattr(tl, name)(**kwargs), arrays, offset)


BI = [
    ("BiEncoderLoss", {}, False),
    ("BiEncoderLoss", {"pos_aware_negative_filtering": True, "filter_threshold": 0.1}, False),
    ("BiPairedEncoderLoss", {}, False),
    ("BiPairwiseCELoss", {"temperature": 0.1}, False),
    ("BiPairwiseCELoss", {"pos_aware_negative_filtering": True, "filter_threshold": 0.1}, False),
    ("BiSigmoidLoss", {}, False),
    ("BiNegativeCELoss", {}, True),
    ("BiPairwiseNegativeCELoss", {}, True),
]


@pytest.mark.parametrize("name,kwargs,negatives", BI)
def test_bi_encoder_loss_matches_jax(name, kwargs, negatives):
    # BiPairedEncoderLoss transposes the score matrix: C == B; the others also take gathered docs
    offset = 0 if name in ("BiPairedEncoderLoss", "BiPairwiseCELoss") else 2
    q, d, n = _single(seed=len(name), c=4 + offset)
    arrays = (q, d, n) if negatives else (q, d)
    _compare(getattr(jl, name)(**kwargs), getattr(tl, name)(**kwargs), arrays, offset)


@pytest.mark.parametrize("name", ["ColbertPairwiseCELoss", "BiPairwiseCELoss"])
def test_top2_tie_takes_the_lower_column_like_jax(name):
    """Docs 1 and 2 are the same, so row 0's two best negatives tie, and
    row 1's positive ties with a negative: values and gradients follow
    ``lax.top_k``'s lower-index rule on both sides."""
    if name.startswith("Colbert"):
        q, d, _ = _multi(seed=5)
        d[2] = d[1]
        q[0] = d[1][:5]  # row 0 scores docs 1 and 2 highest, equally
    else:
        q, d, _ = _single(seed=5)
        d[2] = d[1]
        q[0] = d[1]
    _compare(getattr(jl, name)(temperature=0.2), getattr(tl, name)(temperature=0.2), (q, d), 0)


def test_out_of_bounds_warning_is_reported_without_changing_the_value():
    q, d, _ = _multi(seed=9)
    q *= 3.0  # unnormalized: scores leave [0, 1]
    quiet = tl.ColbertLoss()(torch.from_numpy(q), torch.from_numpy(d))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = tl.ColbertLoss(warn_out_of_bounds=True)
        loud = loss(torch.from_numpy(q), torch.from_numpy(d))
        assert not caught  # the call itself keeps the bounds on the device and reads nothing
        loss.flush_warnings()
    assert torch.equal(quiet, loud)
    assert any("out of bounds" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss = tl.ColbertLoss(warn_out_of_bounds=True)
        loss(torch.from_numpy(q / 3.0), torch.from_numpy(d))
        loss.flush_warnings()
    assert not caught


def test_invalid_hyperparameters_raise():
    with pytest.raises(ValueError, match="Temperature"):
        tl.ColbertLoss(temperature=0.0)
    with pytest.raises(ValueError, match="in_batch_term_weight"):
        tl.ColbertNegativeCELoss(in_batch_term_weight=1.5)
    with pytest.raises(ValueError, match="in_batch_term_weight"):
        tl.BiPairwiseNegativeCELoss(in_batch_term_weight=-0.1)
