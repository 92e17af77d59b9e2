"""Port parity: LoRA training of ColQwen3_5 (Qwen3.5's hybrid GatedDeltaNet /
gated attention decoder over Qwen3-VL's tower) in colpali_tpu_torch against
colpali_tpu, on the CPU, fp32, at the tiny widths of
``scripts/gate_families.py``'s ``make_synth_colqwen35`` (every weight then
moved by seeded noise, so norms are off 1 and ``A_log``/``dt_bias`` off
their draws). The oracle is JAX's step composed around a keyword forward
(``tests/qwen_lora_oracle.py``).

- The adapted kernels are the paths JAX's ``init_lora_params`` picks: q/k/v/o
  of the gated attention layers, gate/up/down of every MLP and shared
  expert, the head; ``in_proj_qkvz``, ``out_proj`` and the stacked experts
  take none. At the default config's full width (JAX's tree under
  ``jax.eval_shape``, the port's model on ``meta``): 12 x 4 + 48 x 3 + 1.
- The gradient through ``SparseMoeBlock`` in both dispatch modes (exact,
  and capacity with dropped tokens) against ``jax.grad``.
- Two LoRA steps (``ColbertLoss(temperature=0.02)``, ``remat=True``)
  against JAX's: loss rtol 1e-4, grad norm rtol 1e-3, adapters atol 1e-5
  (``tests/qwen_lora_oracle.py``'s), each leaf's gradient within 1e-3 of
  its RMS, and an entry whose gradient is within that of 0 held to the
  Adam steps' bound (``tests/test_torch_qwen2_training.py``'s rule: Adam
  turns a gradient near 0 into a step of either sign); the gradient
  reaches every adapter through the GatedDeltaNet layers (autograd through Q2's plain version),
  the gated attention on the biased route and the MoE blocks.
- The merged export (``ColModelTraining.save``) read back by
  ``load_retriever(family="colqwen3_5")`` bit for bit.
- ``configs/train_colqwen3_5.yaml`` through ``load_config`` builds the
  port's classes (the default config on ``meta``); the tiny model with the
  recipe's options trains through ``ColModelTraining`` over a
  ``quantize_frozen_base`` tower with ``mask_non_image_embeddings``; the
  YAML CLI runs the recipe over a checkpoint written by
  ``utils.testing.write_qwen35_checkpoint``.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.core.hf_loader import load_colqwen35_params as jax_load_params  # noqa: E402
from colpali_tpu.models import qwen3_5 as jq  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.configs import load_config  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax, state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.models import qwen3_5 as tq  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from colpali_tpu_torch.utils.testing import write_qwen35_checkpoint  # noqa: E402
from qwen_lora_oracle import (  # noqa: E402
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    QUERIES,
    RANK,
    TRAIN,
    JaxOracle,
    assert_adapters,
    examples,
    recording_gradients,
    start_adapters,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
TIED = np.log(3)  # ColbertLoss over a batch of 3 whose pages all score alike
GRAD_RTOL_RMS = 1e-3  # tests/test_torch_qwen2_training.py's: a leaf's gradient within 1e-3 of its RMS of JAX's


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, its params moved by seeded noise, the checkpoint dir)."""
    import gate_families as gf

    path = tmp_path_factory.mktemp("synth") / "colqwen3_5-tiny"
    init = jq.ColQwen3_5.init

    def drawn(self, rng, **kw):  # JAX's tree by shapes alone (no compile), seeded numpy draws: norms 1, the rest 0.02
        draw = np.random.default_rng(4)
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.ones(x.shape, x.dtype) if "norm" in jax.tree_util.keystr(p) else
            (draw.normal(size=x.shape) * 0.02).astype(x.dtype), jax.eval_shape(lambda r: init(self, r, **kw), rng))

    jq.ColQwen3_5.init = drawn
    try:
        gf.make_synth_colqwen35(str(path))
    finally:
        jq.ColQwen3_5.init = init
    jmodel = jq.ColQwen3_5(jq.Qwen35VLConfig.from_hf_config(json.loads((path / "config.json").read_text())),
                           dtype=jnp.float32, param_dtype=jnp.float32)
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(size=x.shape) * 0.05).astype(np.float32),
                          jax_load_params(str(path)))
    return jmodel, params, str(path)


def port_model(synth, remat=False, **kwargs):
    model, proc = load_retriever(synth[2], family="colqwen3_5", dtype=torch.float32, device="cpu", remat=remat,
                                 **kwargs)
    model.load_state_dict(state_dict_from_jax(synth[1]))
    return model.train(), proc


def test_adapter_paths_match_init_lora_params(synth):
    model = port_model(synth)[0]
    want = jlora.init_lora_params(synth[1], jax.random.PRNGKey(1), rank=RANK)
    paths = LoraAdapters(model, SPEC).paths
    assert sorted(paths) == sorted(want) and not any("visual" in p for p in paths)
    assert not any(name in p for p in paths for name in ("in_proj", "out_proj", "experts/", "linear_attn"))
    # the gated attention layer's q/k/v/o, each layer's shared expert gate/up/down (MoE on every layer), the head
    assert len(paths) == 4 + 3 * model.config.text.num_hidden_layers + 1


def test_adapter_count_matches_jax_at_full_width():
    """JAX's ``init_lora_params`` over the default config's tree under ``jax.eval_shape`` (nothing materialised)
    against ``LoraAdapters`` over the port's model on ``meta``: the same paths, 193 at rank 32."""
    default = jq.Qwen35VLConfig()
    full = dataclasses.replace(default, vision=dataclasses.replace(default.vision, out_hidden_size=2048))
    p, s = 16, 12
    shapes = jax.eval_shape(jq.ColQwen3_5(full).init, jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
                            jnp.ones((1, s), jnp.int32), jnp.zeros((1, p, full.vision.patch_dim), jnp.float32),
                            vision_hpos=jnp.zeros((1, p), jnp.int32), vision_wpos=jnp.zeros((1, p), jnp.int32),
                            patch_mask=jnp.ones((1, p), bool), pos_idx=jnp.zeros((1, p, 4), jnp.int32),
                            pos_weight=jnp.zeros((1, p, 4), jnp.float32))["params"]
    want = jax.eval_shape(lambda x: jlora.init_lora_params(x, jax.random.PRNGKey(1), rank=32), shapes)
    port_default = tq.Qwen35VLConfig()
    meta = tq.ColQwen3_5(dataclasses.replace(port_default, vision=dataclasses.replace(
        port_default.vision, out_hidden_size=2048)), device="meta", dtype=torch.bfloat16)
    adapters = LoraAdapters(meta, LoraSpec(rank=32, alpha=32.0))
    assert sorted(adapters.paths) == sorted(want)
    text = full.text
    assert len(adapters.paths) == 12 * 4 + text.num_hidden_layers * 3 + 1 == 193
    for i, path in enumerate(adapters.paths):
        assert tuple(adapters.a[i].shape) == tuple(want[path]["a"].shape), path
        assert tuple(adapters.b[i].shape) == tuple(want[path]["b"].shape), path


@pytest.mark.parametrize("capacity_factor", [0.0, 0.6], ids=["exact", "capacity"])
def test_sparse_moe_block_gradient_matches_jax(synth, capacity_factor):
    """The gradient through ``SparseMoeBlock`` (the router's softmax, top-k, the stacked experts, the gated shared
    expert) against ``jax.grad`` in both dispatch modes (74 tokens x 2 choices over 4 experts of 23 slots: the
    capacity mode drops tokens): the input's and every weight's, at 1e-5 of each one's RMS."""
    jmodel, params, _ = synth
    cfg = dataclasses.replace(jmodel.config.text, moe_capacity_factor=capacity_factor)
    mlp = params["model"]["language_model"]["layers_1"]["mlp"]
    x = np.random.default_rng(9).normal(size=(2, 37, cfg.hidden_size)).astype(np.float32)
    w = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    want_x, want_p = jax.jit(jax.grad(lambda xx, pp: jnp.sum(jq.SparseMoeBlock(cfg).apply({"params": pp}, xx) * w),
                                      argnums=(0, 1)))(jnp.asarray(x), mlp)

    def port_names(tree):  # the block's own names: core/from_jax.py reads whole models' trees
        prefix = "model.language_model.layers.1.mlp."
        full = state_dict_from_jax({"model": {"language_model": {"layers_1": {"mlp": jax.tree.map(np.asarray, tree)}}}})
        return {k[len(prefix):]: v for k, v in full.items()}

    block = tq.SparseMoeBlock(tq.Qwen35TextConfig(**dataclasses.asdict(cfg)), device="cpu")
    block.load_state_dict(port_names(mlp))
    xt = torch.from_numpy(x).requires_grad_()
    (block(xt) * torch.from_numpy(w)).sum().backward()
    want = {"x": np.asarray(want_x), **{k: v.numpy() for k, v in port_names(want_p).items()}}
    got = {"x": xt.grad.numpy(), **{k: p.grad.numpy() for k, p in block.named_parameters()}}
    assert set(got) == set(want) and len(got) == 9
    for key, value in want.items():
        rms = np.sqrt(np.mean(np.square(value)))
        np.testing.assert_allclose(got[key], value, atol=1e-5 * rms + 1e-7, rtol=0, err_msg=key)


def test_lora_steps_match_jax(synth):
    jmodel, params, _ = synth
    col, proc = port_model(synth)
    model, _ = port_model(synth, remat=True)
    start = start_adapters(params)
    batch = VisualRetrieverCollator(proc)(examples(3, seed=50))
    oracle = JaxOracle(jmodel, params, start, jlosses.ColbertLoss(temperature=0.02), False)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tlosses.ColbertLoss(temperature=0.02), peft=SPEC)
    grads = recording_gradients(state)
    near_eps = {p: {n: np.zeros(v.shape, bool) for n, v in ab.items()} for p, ab in start.items()}
    for _ in range(2):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
        assert abs(got["loss"].item() - TIED) > 1e-3, got["loss"].item()
        for path, ab in grads[-1].items():  # the gradients before clipping and Adam, per leaf
            for name, g in ab.items():
                w = oracle.grads[path][name]
                noise = GRAD_RTOL_RMS * np.sqrt(np.mean(np.square(w)))
                assert np.abs(g - w).max() <= noise, f"{path}/{name}"
                near_eps[path][name] |= np.abs(w) < noise
    # an entry whose gradient is within the sums' noise of 0 takes an Adam step of either sign: held to the step
    lr_sum = sum(ttrainer.learning_rate_at(state.config, count) for count in range(state.step))
    assert_adapters(adapters, oracle.lora, start, near_eps, step_bound=2 * lr_sum)


def test_merged_export_reads_back_bit_for_bit(synth, tmp_path):
    """``ColModelTraining.save`` over adapters moved off zero: the HF export read back by
    ``load_retriever(family="colqwen3_5")`` equals the merged weights in memory bit for bit."""
    model, proc = port_model(synth)
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=proc, loss_func=tlosses.ColbertLoss(), peft=SPEC,
        train_datasets=[ColPaliEngineDataset(examples(2))], global_batch_size=2, output_dir=str(tmp_path / "run"),
        report_to="none", device="cpu"))
    app.state.adapters.load_tree(lora_from_jax(start_adapters(synth[1])))
    out = str(tmp_path / "export")
    app.save(out)
    merged = app.state.adapters.merged_state_dict(model)
    back, _ = load_retriever(out, family="colqwen3_5", dtype=torch.float32, device="cpu")
    assert type(back) is tq.ColQwen3_5 and back.config == model.config
    state = back.state_dict()
    assert state.keys() == merged.keys()
    for key, value in merged.items():
        assert torch.equal(state[key], value), key
    changed = [k for k, v in merged.items() if not torch.equal(v, model.state_dict()[k])]
    assert len(changed) == len(app.state.adapters.paths)
    app.close()


def test_recipe_builds_the_ports_classes_and_trains_over_an_int8_tower(synth, tmp_path):
    """``configs/train_colqwen3_5.yaml`` through ``load_config`` (the default config on ``meta``, never
    materialised); then the tiny model with the recipe's loss and LoRA through ``ColModelTraining(
    quantize_frozen_base=True)`` with ``mask_non_image_embeddings``: one step, no gradient through the int8
    tower, finite."""
    raw = yaml.safe_load((REPO / "configs" / "train_colqwen3_5.yaml").read_text())
    node = raw["config"]
    assert node["model"]["_target_"] == "colpali_tpu.models.ColQwen3_5" and node["model"]["scan_layers"] is True
    node["model"].update(device="meta")
    for key in ("processor", "params", "train_datasets"):
        del node[key]
    (tmp_path / "recipe.yaml").write_text(yaml.safe_dump(raw))
    full = load_config(str(tmp_path / "recipe.yaml"))
    recipe_model = full["model"]
    assert type(recipe_model) is tq.ColQwen3_5 and recipe_model.config == tq.Qwen35VLConfig()
    assert recipe_model.model.language_model.remat and recipe_model.head.custom_text_proj.out_features == 128
    assert type(full["loss_func"]) is tlosses.ColbertLoss and full["loss_func"].temperature == 0.02
    assert (full["peft"].rank, full["peft"].alpha, full["peft"].dropout) == (32, 32, 0.1)

    model, proc = port_model(synth, remat=True, mask_non_image_embeddings=True)
    assert model.mask_non_image_embeddings
    app = ColModelTraining(ColModelTrainingConfig(**dict(
        full, model=model, processor=proc, train_datasets=[ColPaliEngineDataset(examples(4, seed=20))],
        global_batch_size=2, max_steps=1, output_dir=str(tmp_path / "run"), log_steps=1, save_steps=100,
        report_to="none", device="cpu", quantize_frozen_base=True, quant_min_dim=32)))
    assert app.quantized_paths and all("visual" in p for p in app.quantized_paths)
    losses = []
    app.train(on_step=lambda step, m: losses.append(m["loss"].item()))
    assert len(losses) == 1 and np.isfinite(losses[0])
    feed = ttrainer.to_device(next(iter(app.batches(0))), "cpu")
    merged, _ = model.model.visual(*(feed[f"doc_{k}"] for k in ("pixel_values", "vision_hpos", "vision_wpos",
                                                                "patch_mask", "pos_idx", "pos_weight")),
                                   deepstack=False)
    assert not merged.requires_grad
    app.close()


def test_cli_trains_the_recipe_over_a_written_checkpoint(synth, tmp_path):
    """``python -m colpali_tpu_torch.train`` over ``configs/train_colqwen3_5.yaml`` with its checkpoint paths
    pointed at one that ``write_qwen35_checkpoint`` wrote (the tiny widths at Qwen's vocabulary and special
    ids), its model config read from that checkpoint and a small offline dataset: two steps, the merged export
    read back."""
    from colpali_tpu_torch import train as cli

    tiny = port_model(synth)[0].config
    config = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, vocab_size=151936), image_token_id=151655,
                                 vision_start_token_id=151652)
    ckpt = str(tmp_path / "ckpt")
    write_qwen35_checkpoint(ckpt, config, seed=6, words=" ".join(QUERIES).split(), device="cpu")
    raw = yaml.safe_load((REPO / "configs" / "train_colqwen3_5.yaml").read_text())
    node = raw["config"]
    node["model"]["config"] = {"_target_": "colpali_tpu.models.qwen3_5.Qwen35VLConfig.from_hf_config",
                               "cfg": json.loads((Path(ckpt) / "config.json").read_text())}
    node["model"]["device"] = "cpu"
    node["processor"]["path"] = node["params"]["checkpoint_dir"] = ckpt
    node["processor"].update(max_num_visual_tokens=64, device="cpu")
    node["train_datasets"] = [{"_target_": "colpali_tpu_torch.utils.testing.load_dummy_dataset", "n": 4}]
    node.update(output_dir=str(tmp_path / "run"), global_batch_size=2, device="cpu", report_to="none", log_steps=1)
    (tmp_path / "recipe.yaml").write_text(yaml.safe_dump(raw))
    summary = cli.main([str(tmp_path / "recipe.yaml")])
    assert summary["final_step"] == 2
    assert {"model.safetensors", "training_config.yml"} <= set(os.listdir(tmp_path / "run"))
    back, _ = load_retriever(str(tmp_path / "run"), family="colqwen3_5", dtype=torch.float32, device="cpu")
    assert type(back) is tq.ColQwen3_5 and back.config == config
