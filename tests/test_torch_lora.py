"""Port parity: colpali_tpu_torch.training.lora against
colpali_tpu.training.lora on the tiny ColPali in fp32.

The port computes the branch form ``x @ W + (alpha/r) (x @ (m * A)) @ B``
on each adapted layer; the JAX package merges ``W + (alpha/r) A @ B`` and
drops rows of ``A``. Tolerance: atol=2e-5 on the L2-normalized outputs (the
same function, summed in another order); the merged export atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.models.paligemma import ColPali as JaxColPali
from colpali_tpu.training import lora as jlora
from colpali_tpu.utils.testing import tiny_colpali_config as jax_tiny_config
from colpali_tpu_torch.core.from_jax import state_dict_from_jax, lora_from_jax
from colpali_tpu_torch.models.paligemma import ColPali
from colpali_tpu_torch.training.lora import DEFAULT_TARGET_PATTERN, LoraAdapters, LoraSpec, jax_kernel_path
from colpali_tpu_torch.utils.testing import tiny_colpali_config

DIM, ATOL = 8, 2e-5
SPEC = LoraSpec(rank=4, alpha=8.0, dropout=0.25)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.full((3, 4), 2), rng.integers(3, 60, size=(3, 5))], axis=1).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 7:] = 0
    pixels = rng.normal(size=(3, 28, 28, 3)).astype(np.float32)
    jmodel = JaxColPali(jax_tiny_config(), dim=DIM)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels))
    params = jax.tree.map(np.asarray, variables["params"])
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=SPEC.rank))
    lora = {p: {"a": ab["a"] * 30, "b": rng.normal(size=ab["b"].shape).astype(np.float32) * 0.3}
            for p, ab in lora.items()}  # large enough to move the outputs well beyond the tolerance
    apply = jax.jit(jmodel.apply)

    def jax_forward(tree):
        return np.asarray(apply({"params": tree}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels)))

    model = ColPali(tiny_colpali_config(), dim=DIM, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    adapters = LoraAdapters(model, SPEC)
    adapters.load_tree(lora_from_jax(lora))

    def port_forward(m=model):
        with torch.no_grad():
            return m(torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(pixels)).numpy()

    return params, lora, jax_forward, model, adapters, port_forward


def test_same_kernels_matched_as_init_lora_params(setup):
    params, lora, _, model, adapters, _ = setup
    assert set(adapters.paths) == set(lora) and len(adapters.paths) == 8
    for path, ab in adapters.tree().items():
        assert ab["a"].shape == lora[path]["a"].shape and ab["b"].shape == lora[path]["b"].shape
    assert DEFAULT_TARGET_PATTERN == jlora.DEFAULT_TARGET_PATTERN
    assert jax_kernel_path("model.language_model.layers.11.mlp.up_proj") == \
        "model/language_model/layers_11/mlp/up_proj/kernel"
    fresh = LoraAdapters(ColPali(tiny_colpali_config(), dim=DIM, device="cpu"), LoraSpec(rank=2), seed=3)
    assert all(float(b.detach().abs().max()) == 0.0 for b in fresh.b)  # training starts at the base model
    assert 0.005 < float(torch.cat([a.detach().flatten() for a in fresh.a]).std()) < 0.02
    with pytest.raises(ValueError, match="matched no kernels"):
        LoraAdapters(ColPali(tiny_colpali_config(), dim=DIM, device="cpu"), LoraSpec(target_pattern="nothing"))


def test_branch_form_equals_merge_lora(setup):
    params, lora, jax_forward, _, adapters, port_forward = setup
    adapters.clear_masks()
    base = jax_forward(jax.tree.map(jnp.asarray, params))
    want = jax_forward(jlora.merge_lora(params, lora, alpha=SPEC.alpha, rank=SPEC.rank))
    got = port_forward()
    assert np.abs(want - base).max() > 100 * ATOL  # the adapters matter
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_injected_mask_equals_row_dropped_a(setup):
    params, lora, jax_forward, _, adapters, port_forward = setup
    rng = np.random.default_rng(2)
    keep = 1.0 - SPEC.dropout
    masks = {p: (rng.random(ab["a"].shape[0]) < keep).astype(np.float32) / keep for p, ab in lora.items()}
    dropped = {p: {"a": ab["a"] * masks[p][:, None], "b": ab["b"]} for p, ab in lora.items()}
    want = jax_forward(jlora.merge_lora(params, dropped, alpha=SPEC.alpha, rank=SPEC.rank))
    adapters.set_masks({p: torch.from_numpy(m) for p, m in masks.items()})
    got = port_forward()
    adapters.clear_masks()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(got - port_forward()).max() > 100 * ATOL  # the mask matters


def test_drawn_masks_follow_seed_and_step(setup):
    adapters = setup[4]
    keep = 1.0 - SPEC.dropout
    adapters.draw_masks(seed=0, step=5)
    first = [m.clone() for m in adapters._masks]
    adapters.draw_masks(seed=0, step=6)
    other = [m.clone() for m in adapters._masks]
    adapters.draw_masks(seed=0, step=5)
    assert all(torch.equal(a, b) for a, b in zip(first, adapters._masks))
    assert any(not torch.equal(a, b) for a, b in zip(first, other))
    values = torch.cat(first)
    assert set(values.unique().tolist()) <= {0.0, float(np.float32(1.0) / np.float32(keep))}
    assert [m.shape[0] for m in first] == [a.shape[0] for a in adapters.a]
    assert 0.5 < float((values > 0).float().mean()) < 0.95
    adapters.clear_masks()


def test_masks_survive_the_recompute_of_a_checkpointed_layer(setup):
    """One mask per layer per step, drawn before the forward: with remat the
    recomputed forward sees the same mask, so the gradients are equal."""
    params, lora, _, _, _, _ = setup
    ids = torch.tensor([[5, 9, 11, 3], [7, 8, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0]])
    grads = []
    for remat in (False, True):
        model = ColPali(tiny_colpali_config(), dim=DIM, device="cpu", remat=remat)
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        adapters = LoraAdapters(model, SPEC)
        adapters.load_tree(lora_from_jax(lora))
        adapters.draw_masks(seed=1, step=0)
        torch.manual_seed(remat)  # the global generator's state must not matter
        model.train()
        model(ids, mask).square().sum().backward()
        grads.append([p.grad.clone() for p in adapters.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads)) and len(grads[0]) == 16


def test_merged_export_equals_merge_lora(setup):
    params, lora, _, model, adapters, port_forward = setup
    adapters.clear_masks()
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, jlora.merge_lora(params, lora, alpha=SPEC.alpha, rank=SPEC.rank)))
    got = adapters.merged_state_dict(model)
    assert got.keys() == want.keys() == model.state_dict().keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-6)
    served = ColPali(tiny_colpali_config(), dim=DIM, device="cpu")
    served.load_state_dict(got, strict=True)
    np.testing.assert_allclose(port_forward(served), port_forward(), atol=ATOL)
