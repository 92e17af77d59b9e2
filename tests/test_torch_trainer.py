"""Port parity: colpali_tpu_torch.training.trainer against
colpali_tpu.training.trainer on the tiny ColPali (1 + 1 layers, width 16) in
fp32, weights and adapters carried over by core/from_jax.py, the same batch
from a numpy seed.

Tolerance: loss rtol=1e-4, grad_norm rtol=1e-3, adapters atol=1e-5 after
three LoRA steps (fp32 forward and backward summed in another order, then
Adam's m / sqrt(v), which keeps a gradient's relative error); the schedule
and the clip to fp32 rounding (rtol=1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colpali_tpu import losses as jlosses
from colpali_tpu.models.paligemma import ColPali as JaxColPali
from colpali_tpu.training import lora as jlora
from colpali_tpu.training import trainer as jtrainer
from colpali_tpu.utils.testing import tiny_colpali_config as jax_tiny_config
from colpali_tpu_torch import losses as tlosses
from colpali_tpu_torch.core.from_jax import state_dict_from_jax, lora_from_jax
from colpali_tpu_torch.models.paligemma import ColPali
from colpali_tpu_torch.training import trainer as ttrainer
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
from colpali_tpu_torch.utils.testing import tiny_colpali_config

DIM = 8
IMAGE_TOKEN = 2


def make_batch(seed=0, b=4, negatives=False):
    rng = np.random.default_rng(seed)
    s_q, s_d = 7, 9
    q_mask = np.ones((b, s_q), np.int32)
    q_mask[1, 5:] = 0
    batch = {
        "query_input_ids": rng.integers(3, 60, size=(b, s_q)).astype(np.int32),
        "query_attention_mask": q_mask,
        "doc_input_ids": np.concatenate([np.full((b, 4), IMAGE_TOKEN), rng.integers(3, 60, size=(b, s_d - 4))],
                                        axis=1).astype(np.int32),
        "doc_attention_mask": np.ones((b, s_d), np.int32),
        "doc_pixel_values": rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
    }
    if negatives:
        batch["neg_doc_input_ids"] = rng.integers(3, 60, size=(b, 2, s_q)).astype(np.int32)
        batch["neg_doc_attention_mask"] = np.ones((b, 2, s_q), np.int32)
    return batch


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxColPali(jax_tiny_config(), dim=DIM)
    batch = make_batch()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["doc_input_ids"]),
                                    jnp.asarray(batch["doc_attention_mask"]), jnp.asarray(batch["doc_pixel_values"]))
    params = jax.tree.map(np.asarray, variables["params"])
    return jmodel, params


def port_model(params, remat=False):
    model = ColPali(tiny_colpali_config(), dim=DIM, device="cpu", remat=remat)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_three_lora_steps_match_jax(pair):
    jmodel, params = pair
    spec = LoraSpec(rank=4, alpha=8.0, dropout=0.0)
    config = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01, max_grad_norm=0.05)
    rng = np.random.default_rng(1)
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=spec.rank))
    lora = {p: {"a": ab["a"], "b": rng.normal(size=ab["b"].shape).astype(np.float32) * 0.05}
            for p, ab in lora.items()}  # b starts at zero: give it values, so that a gets a gradient too
    batch = make_batch(negatives=True)

    jspec = jlora.LoraSpec(rank=spec.rank, alpha=spec.alpha, dropout=0.0)
    jstate = jtrainer.create_train_state(jmodel.apply, jax.tree.map(jnp.asarray, lora), jtrainer.TrainConfig(**config))
    jstep = jax.jit(jtrainer.make_peft_train_step(jlosses.ColbertNegativeCELoss(), jspec, has_negatives=True))

    model = port_model(params)
    adapters = LoraAdapters(model, spec)
    adapters.load_tree(lora_from_jax(lora))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**config), adapters)
    step = ttrainer.make_train_step(tlosses.ColbertNegativeCELoss(), has_negatives=True, peft=spec)
    assert len(state.optimizer.state_dict()["param_groups"][0]["params"]) == 2 * len(adapters.paths)
    assert not any(p.requires_grad for p in model.parameters())

    for _ in range(3):
        jstate, want = jstep(jstate, jbatch(batch), params)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)
    assert state.step == int(jstate.step) == 3
    assert float(want["grad_norm"]) > config["max_grad_norm"]  # the clip was active
    for path, ab in adapters.tree().items():
        for name in ("a", "b"):
            np.testing.assert_allclose(ab[name].numpy(), np.asarray(jstate.params[path][name]), atol=1e-5)
            assert not np.array_equal(ab[name].numpy(), lora[path][name])  # it moved


def test_two_full_steps_match_jax(pair):
    jmodel, params = pair
    config = dict(learning_rate=1e-3, warmup_steps=0, total_steps=4)
    batch = make_batch(seed=3)
    jstate = jtrainer.create_train_state(jmodel.apply, jax.tree.map(jnp.asarray, params),
                                         jtrainer.TrainConfig(**config))
    jstep = jax.jit(jtrainer.make_train_step(jlosses.ColbertPairwiseCELoss()))
    state = ttrainer.create_train_state(port_model(params), ttrainer.TrainConfig(**config))
    step = ttrainer.make_train_step(tlosses.ColbertPairwiseCELoss())
    for _ in range(2):
        jstate, want = jstep(jstate, jbatch(batch))
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)
    head = state.model.head.custom_text_proj.weight.detach().numpy()
    np.testing.assert_allclose(head, np.asarray(jstate.params["head"]["custom_text_proj"]["kernel"]).T, atol=1e-5)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (5, 5), (4, 2)])
def test_schedule_equals_optax_at_every_count(warmup, total):
    config = ttrainer.TrainConfig(learning_rate=5e-5, warmup_steps=warmup, total_steps=total)
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, config.learning_rate, warmup),
         optax.linear_schedule(config.learning_rate, 0.0, max(total - warmup, 1))], boundaries=[warmup])
    for count in range(total + 4):
        np.testing.assert_allclose(ttrainer.learning_rate_at(config, count), float(schedule(count)), rtol=1e-6,
                                   atol=1e-12)
    if warmup:
        assert ttrainer.learning_rate_at(config, 0) == 0.0  # the first update of a warm-up moves nothing


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_equals_optax(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) for s in [(5, 3), (7,), (2, 2, 2)]]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    tensors = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrainer.clip_by_global_norm_(tensors, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6)


def test_remat_gives_the_same_gradients(pair):
    _, params = pair
    batch = ttrainer.to_device(make_batch(seed=5), "cpu")
    grads = []
    for remat in (False, True):
        model = port_model(params, remat=remat).train()
        loss, _, _ = ttrainer.compute_loss(model, batch, tlosses.ColbertLoss(), False)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 20
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_frozen_tower_runs_without_recording_a_gradient(pair):
    """With LoRA the vision tower and projector take no gradient: their
    features come out detached, and the backward leaves them untouched."""
    _, params = pair
    model = port_model(params)
    LoraAdapters(model, LoraSpec(rank=2, dropout=0.0))
    pixels = torch.from_numpy(make_batch()["doc_pixel_values"])
    assert not model.model.image_features(pixels).requires_grad
    full = port_model(params)
    assert full.model.image_features(pixels).requires_grad
