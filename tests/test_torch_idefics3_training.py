"""Port parity: LoRA training of ColIdefics3 (ColSmol) in colpali_tpu_torch
against colpali_tpu, on the CPU, fp32, on ``make_synth_colsmol(tiny=True)``'s
checkpoint (vision 2 x 32 over 64 px tiles, pixel shuffle 2; text 2 x 48,
GQA 4/2) that each package's ``load_retriever`` reads; JAX's attention on
its einsum route (no Pallas).

- ``VisualRetrieverCollator`` on pages of 13, 7 and 1 tiles (tiles padded
  over T within each sub-batch, ``(B, n_neg, T, S, S, 3)`` under
  negatives) against JAX's: integers exactly, pixels at 1e-4.
- The adapted kernels under ``DEFAULT_TARGET_PATTERN`` (``text_model``'s
  q/k/v/o/gate/up/down and ``head/linear``) are the paths JAX's
  ``init_lora_params`` picks.
- Two LoRA steps against JAX's own ``make_peft_train_step`` (its
  ``_forward`` passes the tiles positionally, which is all Idefics3 needs),
  with ``ColbertPairwiseCELoss`` and, over negatives, with
  ``ColbertNegativeCELoss``; the port under remat: loss rtol 1e-4, grad
  norm rtol 1e-3, adapters atol 1e-5, as ``tests/test_torch_trainer.py``
  holds ColPali.
- The decoder under the key-padding mask (``Qwen2Decoder(key_padding=
  True)``: queries id 1, keys the mask) against ``jax.grad`` of JAX's
  Idefics3 text stack with ``make_attention_bias`` on a right-padded batch,
  with a gradient on every row, pad rows too: atol 2e-5 relative to the
  largest gradient.
- ``quantize_frozen_base`` stores JAX's layers (the vision tower only; the
  connector stays float) and the frozen tower records no gradient;
  ``ColModelTraining`` evaluates through a bf16 index, resumes repeating
  the step's loss, and its merged export reads back through
  ``load_retriever(family="colidefics3")``; the ColSmol and BiIdefics3
  recipes build the port's classes (``configs.instantiate``, with the
  nodes that name absent files replaced), and the ColSmol recipe trains.
"""

import os
import shutil
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
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator  # noqa: E402
from colpali_tpu.models import layers as jl  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu.training import trainer as jtrainer  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.configs import instantiate  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax, state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.models.layers import QDense  # noqa: E402
from colpali_tpu_torch.models.qwen2_vl import text_positions  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from colpali_tpu_torch.utils.testing import idefics3_training_examples  # noqa: E402
from qwen_lora_oracle import (  # noqa: E402
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    RANK,
    TRAIN,
    assert_adapters,
    assert_collated_like_jax,
    start_adapters,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
LOSSES = {"pairwise": (jlosses.ColbertPairwiseCELoss, tlosses.ColbertPairwiseCELoss, 0),
          "negatives": (jlosses.ColbertNegativeCELoss, tlosses.ColbertNegativeCELoss, 1)}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, variables, JAX processor, checkpoint dir), fp32."""
    import validate_checkpoint as vc

    path = str(tmp_path_factory.mktemp("synth") / "colsmol-tiny")
    vc.make_synth_colsmol(path, tiny=True)
    return (*jax_load_retriever(path, dtype=jnp.float32, param_dtype=jnp.float32), path)


def port_model(path, **kw):
    model, proc = load_retriever(path, family="colidefics3", dtype=torch.float32, device="cpu", **kw)
    return model.train(), proc


def jbatch(batch):
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("negatives", [0, 2])
def test_collator_batches_match_jax(synth, negatives):
    jproc, path = synth[2], synth[3]
    examples = idefics3_training_examples(3, negatives=negatives)
    got = VisualRetrieverCollator(port_model(path)[1])(examples)
    assert_collated_like_jax(got, JaxCollator(jproc, device_pixels=False)(examples), False)
    assert got["doc_tile_mask"].sum(1).tolist() == [13, 7, 1] and got["doc_pixel_values"].shape[1] == 13
    if negatives:
        assert got["neg_doc_pixel_values"].shape[:3] == (3, negatives, 13)


def test_adapter_paths_match_init_lora_params(synth):
    variables, path = synth[1], synth[3]
    model = port_model(path)[0]
    want = jlora.init_lora_params(variables["params"], jax.random.PRNGKey(1), rank=RANK)
    paths = LoraAdapters(model, SPEC).paths
    assert sorted(paths) == sorted(want) and len(paths) == 7 * model.config.text.num_hidden_layers + 1
    assert "head/linear/kernel" in paths and all(p.startswith("model/text_model/") for p in paths[:-1])


@pytest.mark.parametrize("loss", list(LOSSES))
def test_two_lora_steps_match_jax(synth, loss):
    jmodel, variables, _, path = synth
    jloss, tloss, negatives = LOSSES[loss]
    model, proc = port_model(path, remat=True)  # remat carries the keys' ids into each layer's recompute
    params = variables["params"]
    start = start_adapters(params)
    batch = VisualRetrieverCollator(proc)(idefics3_training_examples(3, negatives=negatives, seed=40))
    assert (np.asarray(batch["query_attention_mask"])[:, -1] == 0).any()  # right padding: pad rows in the batch

    jspec = jlora.LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
    jstate = jtrainer.create_train_state(jmodel.apply, jax.tree.map(jnp.asarray, start), jtrainer.TrainConfig(**TRAIN))
    jstep = jax.jit(jtrainer.make_peft_train_step(jloss(), jspec, has_negatives=bool(negatives)))
    adapters = LoraAdapters(model, SPEC)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tloss(), has_negatives=bool(negatives), peft=SPEC)
    feed = {k: v for k, v in batch.items()}
    for _ in range(2):
        jstate, want = jstep(jstate, jbatch(feed), params)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=NORM_RTOL)
    assert_adapters(adapters, jstate.params, start)


def test_decoder_gradient_matches_jax_key_padding_bias(synth):
    """The text stack alone, pad rows included: their gradient reaches the
    valid keys' k and v only through the keys' own ids."""
    jmodel, variables, _, path = synth
    model = port_model(path)[0]
    rng = np.random.default_rng(7)
    b, s, width = 3, 11, model.config.text.hidden_size
    mask = (np.arange(s)[None] < np.array([11, 6, 2])[:, None]).astype(np.int32)
    embeds = rng.normal(size=(b, s, width)).astype(np.float32)
    d_out = rng.normal(size=(b, s, width)).astype(np.float32)  # every row, pad rows too
    pos = text_positions(torch.from_numpy(mask))

    def jax_loss(params, x):
        out = jmodel.apply({"params": params}, x, jl.make_attention_bias(jnp.asarray(mask), causal=True),
                           jnp.asarray(pos.numpy()), method=lambda m, *a: m.model.text_model(*a))
        return jnp.sum(out * d_out)

    want_params, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(variables["params"], jnp.asarray(embeds))
    want_params = state_dict_from_jax({"model": {"text_model": want_params["model"]["text_model"]}})
    x = torch.from_numpy(embeds).requires_grad_()
    decoder = model.model.text_model
    assert decoder.key_padding
    (decoder(x, torch.from_numpy(mask), pos) * torch.from_numpy(d_out)).sum().backward()
    got = {f"model.text_model.{n}": torch.zeros_like(p) if p.grad is None else p.grad  # the unused embedding
           for n, p in decoder.named_parameters()}
    assert set(got) == set(want_params)
    for name, g in [("inputs_embeds", x.grad), *got.items()]:
        w = np.asarray(want_x) if name == "inputs_embeds" else want_params[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(), rtol=0, err_msg=name)
    k_grad = got["model.text_model.layers.0.self_attn.k_proj.weight"]
    assert k_grad.abs().max() > 0


def test_frozen_tower_and_quantized_base_take_jax_layers(synth, tmp_path):
    variables, path = synth[1], synth[3]
    model, proc = port_model(path)
    tiles = torch.from_numpy(np.asarray(VisualRetrieverCollator(proc)(idefics3_training_examples(2))
                                        ["doc_pixel_values"]))
    assert model.model.image_features(tiles).requires_grad  # nothing is frozen yet
    LoraAdapters(model, SPEC).detach()
    assert not model.model.image_features(tiles).requires_grad

    model = port_model(path)[0]
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=proc, loss_func=tlosses.ColbertPairwiseCELoss(), output_dir=str(tmp_path),
        train_datasets=[ColPaliEngineDataset(idefics3_training_examples(3))], peft=SPEC, device="cpu",
        global_batch_size=3, quantize_frozen_base=True, quant_min_dim=16, report_to="none"))
    qp, _ = jqd.quantize_params(variables["params"], min_dim=16, path_filter=lambda p: "visual" in p or "vision" in p)
    want = sorted("/".join(str(k.key) for k in kp) for kp, leaf in jax.tree_util.tree_leaves_with_path(qp)
                  if leaf.dtype == jnp.int8)
    stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
    assert sorted(app.quantized_paths) == want and len(stored) == 6 * model.config.vision.num_hidden_layers
    assert all(n.startswith("model.vision_model.") for n in stored)
    assert model.model.modality_projection.weight.dtype == torch.float32  # the connector stays float, as in JAX
    summary = app.train()
    assert summary["final_step"] == 1 and not any(m.weight.grad is not None for m in model.modules()
                                                  if isinstance(m, QDense) and m.stored)
    app.close()


def test_training_run_evaluates_resumes_and_exports(synth, tmp_path):
    path = synth[3]
    model, proc = port_model(path, remat=True)
    train_set = ColPaliEngineDataset(idefics3_training_examples(6, seed=50))
    eval_set = ColPaliEngineDataset(idefics3_training_examples(4, seed=60))
    kw = dict(processor=proc, loss_func=tlosses.ColbertPairwiseCELoss(), train_datasets=[train_set],
              eval_dataset=eval_set, global_batch_size=2, log_steps=1, save_steps=2, save_total_limit=3,
              peft=LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.1), report_to="none", device="cpu",
              train=ttrainer.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10))
    app = ColModelTraining(ColModelTrainingConfig(model=model, output_dir=str(tmp_path / "run"), max_steps=3, **kw))
    losses = []
    app.train(on_step=lambda step, m: losses.append(float(m["loss"])))
    metrics = app.evaluate()
    assert len(losses) == 3 and np.isfinite(losses).all() and np.isfinite(list(metrics.values())).all()
    assert app.eval_index.dtype == "bf16" and app.eval_index.num_docs == 4 and "eval_ndcg@5" in metrics
    app.save()
    merged = app.state.adapters.merged_state_dict(model)
    app.close()

    os.makedirs(tmp_path / "resumed" / "checkpoints")
    shutil.copy(tmp_path / "run" / "checkpoints" / "step_2.pt", tmp_path / "resumed" / "checkpoints")
    resumed = ColModelTraining(ColModelTrainingConfig(model=model, output_dir=str(tmp_path / "resumed"), max_steps=3,
                                                      resume_from_checkpoint=True, **kw))
    tail = []
    resumed.train(on_step=lambda step, m: tail.append(float(m["loss"])))
    resumed.close()
    assert tail == pytest.approx([losses[2]], rel=1e-6)

    back, back_proc = load_retriever(str(tmp_path / "run"), family="colidefics3", dtype=torch.float32, device="cpu")
    fresh = port_model(path)[0].eval()
    fresh.load_state_dict(merged)
    feed = {k: torch.as_tensor(np.asarray(v)) for k, v in back_proc.process_images(eval_set[0]["pos_target"]).items()}
    with torch.no_grad():
        assert torch.equal(back(**feed), fresh(**feed))


def recipe(name, model, **nodes):
    """``configs/<name>``'s ``config`` tree built by the port, with ``model``
    merged into its model node and ``nodes`` in place of its own (the
    recipes name checkpoint and dataset files that the repository lacks)."""
    raw = yaml.safe_load((REPO / "configs" / name).read_text())["config"]
    raw["model"].update(model)
    raw.update(nodes)
    return instantiate(raw)


def recipe_config(path, name, tmp_path):
    model, proc = port_model(path)
    negatives = 1 if "hardneg" in name else 0
    data = ColPaliEngineDataset(idefics3_training_examples(3, negatives=negatives),
                                neg_target_column_name="neg_target" if negatives else None)
    return model, recipe(name, dict(config=model.config, device="cpu", dtype=torch.float32), processor=proc,
                         params=None, output_dir=str(tmp_path), global_batch_size=3, log_steps=1, report_to="none",
                         device="cpu", max_steps=1, train_datasets=[data])


@pytest.mark.parametrize("name,model_name,loss_name", [
    ("train_colidefics3.yaml", "ColIdefics3", "ColbertPairwiseCELoss"),
    ("train_colidefics3_hardneg.yaml", "ColIdefics3", "ColbertNegativeCELoss"),
    ("train_biidefics3.yaml", "BiIdefics3", "BiEncoderLoss")])
def test_recipes_resolve_to_the_port(synth, tmp_path, name, model_name, loss_name):
    config = recipe_config(synth[3], name, tmp_path)[1]
    built = config["model"]
    assert type(built).__name__ == model_name and built.model.text_model.remat  # the recipe's remat: true
    assert type(config["loss_func"]).__name__ == loss_name
    assert (config["peft"].rank, config["peft"].alpha, config["peft"].dropout) == (32, 32, 0.1)
    assert (config["train"].learning_rate, config["train"].warmup_steps) == (2e-4, 100)


def test_colsmol_recipe_trains(synth, tmp_path):
    model, config = recipe_config(synth[3], "train_colidefics3.yaml", tmp_path)
    config["model"].load_state_dict(model.state_dict())
    app = ColModelTraining(ColModelTrainingConfig(**config))
    assert app.train()["final_step"] == 1
    app.close()
