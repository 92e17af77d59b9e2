"""Port parity: LoRA training of the ModernVBert family (ColModernVBert,
BiModernVBert) in colpali_tpu_torch against colpali_tpu, on the CPU, fp32,
on ``scripts/gate_families.py::make_synth_colmodernvbert``'s checkpoint
(vision 2 x 32 over 32 px tiles, pixel shuffle 2; a ModernBERT encoder 3 x
48 with a window of 4) that each package's ``load_retriever`` reads. The
text attention is the biased route on both sides (no kernel); the tower is
frozen under LoRA.

- The adapted kernels under ``DEFAULT_TARGET_PATTERN`` (``text_model``'s
  ``attn.{q,k,v,o}_proj``, ``Wi`` and ``Wo``, and ``head/custom_text_proj``)
  are the paths JAX's ``init_lora_params`` picks, nothing of the vision
  model among them: 19 here, 133 at ModernVBERT-base's full widths.
- Two LoRA steps against JAX's step composed from its own pieces
  (``tests/qwen_lora_oracle.py``: ``make_lora_train_step`` and
  ``create_optimizer``; ``tile_mask`` goes through ``MODEL_INPUTS`` on both
  sides and is not read) on pages of 5, 5 and 1 tiles and left-padded
  queries: ColModernVBert with its recipe's ``ColbertLoss(temperature=
  0.02)`` and over negatives with ``ColbertNegativeCELoss`` (the port under
  remat, the first loss held off the value where every page scores alike),
  BiModernVBert with ``BiEncoderLoss``. Loss rtol 1e-4, grad norm rtol
  1e-3; each step's adapter gradients before Adam at 1e-3 of the leaf's
  RMS, and the adapters at 1e-5, but for elements whose gradient lies below
  that noise, held to Adam's step bound (``tests/test_torch_qwen2_training.py``'s
  rule: at temperature 0.02 one such element moved 1.16e-5 apart).
- ``quantize_frozen_base`` stores JAX's layers (the vision tower only; the
  connector stays float) and the frozen tower records no gradient;
  ``ColModelTraining`` evaluates through a bf16 index, resumes repeating
  the step's loss, and its merged export reads back through
  ``load_retriever(family="colmodernvbert")`` bit for bit;
  ``train_colmodernvbert.yaml`` builds the port's classes through
  ``configs.load_config`` and trains.
"""

import os
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO / "tests"))

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator  # noqa: E402
from colpali_tpu.models import modernvbert as jm  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.configs import load_config  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.models import modernvbert as tm  # noqa: E402
from colpali_tpu_torch.models.layers import QDense  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import DEFAULT_TARGET_PATTERN, LoraAdapters, LoraSpec, jax_kernel_path  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from colpali_tpu_torch.utils.testing import idefics3_training_examples  # noqa: E402
from qwen_lora_oracle import (  # noqa: E402
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    RANK,
    TRAIN,
    JaxOracle,
    assert_adapters,
    assert_collated_like_jax,
    recording_gradients,
    start_adapters,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
TILE = 32  # the synthetic checkpoint's tiles; its longest edge is 64
CASES = {"colbert": ("col", lambda m: m.ColbertLoss(temperature=0.02), 0),
         "negatives": ("col", lambda m: m.ColbertNegativeCELoss(), 1),
         "bi": ("bi", lambda m: m.BiEncoderLoss(), 0)}
# the late-interaction losses where every page of a batch of 3 scores alike (ColbertLoss ln 3; the negatives'
# softplus(0) and ln 3 weighted 1:1): a step there compares two gradients that carry no ranking
TIED = {"colbert": np.log(3), "negatives": 0.5 * np.log(2) + 0.5 * np.log(3)}
GRAD_RTOL_RMS = 1e-3  # the adapter gradients before Adam, against JAX's, per leaf (tests/test_torch_qwen2_training.py)


def examples(n, negatives=0, seed=0):
    return idefics3_training_examples(n, tile=TILE, negatives=negatives, seed=seed)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, variables, JAX processor, checkpoint dir), fp32."""
    import gate_families

    path = str(tmp_path_factory.mktemp("synth") / "colmodernvbert-tiny")
    gate_families.make_synth_colmodernvbert(path)
    return (*jax_load_retriever(path, dtype=jnp.float32, param_dtype=jnp.float32), path)


def port_model(path, kind="col", **kw):
    model, proc = load_retriever(path, family="colmodernvbert", dtype=torch.float32, device="cpu", **kw)
    if kind == "bi":
        bi = tm.BiModernVBert(model.config, device="cpu", remat=kw.get("remat", False))
        bi.load_state_dict({k: v for k, v in model.state_dict().items() if k.startswith("model.")})
        model = bi
    return model.train(), proc


def test_collated_batches_match_jax_and_carry_tile_mask(synth):
    jproc, path = synth[2], synth[3]
    got = VisualRetrieverCollator(port_model(path)[1])(examples(3, negatives=1))
    assert_collated_like_jax(got, JaxCollator(jproc, device_pixels=False)(examples(3, negatives=1)), False)
    assert got["doc_tile_mask"].sum(1).tolist() == [5, 5, 1] and "tile_mask" in ttrainer.MODEL_INPUTS
    mask = np.asarray(got["query_attention_mask"])
    assert (mask[:, 0] == 0).any() and mask[:, -1].all()  # left padding


def test_adapter_paths_match_init_lora_params_here_and_at_full_width(synth):
    variables, path = synth[1], synth[3]
    model = port_model(path)[0]
    want = jlora.init_lora_params(variables["params"], jax.random.PRNGKey(1), rank=RANK)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(want) and len(adapters.paths) == 6 * 3 + 1
    assert "head/custom_text_proj/kernel" in adapters.paths
    assert all(p.startswith("model/text_model/") for p in adapters.paths if not p.startswith("head/"))
    adapters.detach()
    # ModernVBERT-base: JAX's init_lora_params over the abstract tree, the port's targets on a model on "meta"
    full = jm.ModernVBertConfig()
    shapes = jax.eval_shape(jm.ColModernVBert(full).init, jax.random.PRNGKey(0), jnp.zeros((1, 80), jnp.int32),
                            jnp.ones((1, 80), jnp.int32), jnp.zeros((1, 1, 512, 512, 3), jnp.float32))["params"]
    full_want = jax.eval_shape(lambda p: jlora.init_lora_params(p, jax.random.PRNGKey(1), rank=32), shapes)
    meta = tm.ColModernVBert(tm.ModernVBertConfig(), device="meta", dtype=torch.bfloat16)
    targets = [jax_kernel_path(n) for n, m in meta.named_modules()
               if isinstance(m, nn.Linear) and re.fullmatch(DEFAULT_TARGET_PATTERN, jax_kernel_path(n))]
    assert sorted(targets) == sorted(full_want) and len(targets) == 6 * 22 + 1 == 133


@pytest.mark.parametrize("case", list(CASES))
def test_two_lora_steps_match_jax(synth, case):
    jmodel, variables, _, path = synth
    kind, loss, negatives = CASES[case]
    model, proc = port_model(path, kind, remat=kind == "col")
    batch = VisualRetrieverCollator(proc)(examples(3, negatives=negatives, seed=40))
    params = variables["params"] if kind == "col" else {"model": variables["params"]["model"]}
    jax_model = jmodel if kind == "col" else jm.BiModernVBert(jmodel.config)
    start = start_adapters(params)
    oracle = JaxOracle(jax_model, params, start, loss(jlosses), negatives)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(loss(tlosses), has_negatives=bool(negatives), peft=SPEC)
    grads = recording_gradients(state)
    near_eps = {p: {n: np.zeros(v.shape, bool) for n, v in ab.items()} for p, ab in start.items()}
    for i in range(2):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        if i == 0 and case in TIED:
            assert abs(got["loss"].item() - TIED[case]) > 0.05, "the pages score alike"
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
        for path, ab in grads[-1].items():  # the gradients before clipping and Adam, per leaf
            for name, g in ab.items():
                w = oracle.grads[path][name]
                noise = GRAD_RTOL_RMS * np.sqrt(np.mean(np.square(w)))
                assert np.abs(g - w).max() <= noise, f"{path}/{name}"
                near_eps[path][name] |= np.abs(w) < noise
    lr_sum = sum(ttrainer.learning_rate_at(state.config, count) for count in range(state.step))
    assert_adapters(adapters, oracle.lora, start, near_eps, step_bound=2 * lr_sum)
    adapters.detach()


def test_frozen_tower_and_quantized_base_take_jax_layers(synth, tmp_path):
    variables, path = synth[1], synth[3]
    model, proc = port_model(path)
    tiles = torch.as_tensor(np.asarray(VisualRetrieverCollator(proc)(examples(2))["doc_pixel_values"]))
    assert model.model.image_features(tiles).requires_grad  # nothing is frozen yet
    LoraAdapters(model, SPEC).detach()
    assert not model.model.image_features(tiles).requires_grad

    model = port_model(path)[0]
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=proc, loss_func=tlosses.ColbertLoss(), output_dir=str(tmp_path),
        train_datasets=[ColPaliEngineDataset(examples(3))], peft=SPEC, device="cpu", global_batch_size=3,
        quantize_frozen_base=True, quant_min_dim=16, report_to="none"))
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
    train_set = ColPaliEngineDataset(examples(6, seed=50))
    eval_set = ColPaliEngineDataset(examples(4, seed=60))
    kw = dict(processor=proc, loss_func=tlosses.ColbertLoss(temperature=0.02), train_datasets=[train_set],
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
    assert "model.embeddings.additional_embedding.weight" in merged  # the image token's table survives the export

    os.makedirs(tmp_path / "resumed" / "checkpoints")
    shutil.copy(tmp_path / "run" / "checkpoints" / "step_2.pt", tmp_path / "resumed" / "checkpoints")
    resumed = ColModelTraining(ColModelTrainingConfig(model=model, output_dir=str(tmp_path / "resumed"), max_steps=3,
                                                      resume_from_checkpoint=True, **kw))
    tail = []
    resumed.train(on_step=lambda step, m: tail.append(float(m["loss"])))
    resumed.close()
    assert tail == pytest.approx([losses[2]], rel=1e-6)

    back, back_proc = load_retriever(str(tmp_path / "run"), family="colmodernvbert", dtype=torch.float32,
                                     device="cpu")
    assert back.config == model.config and type(back_proc).__name__ == "ColModernVBertProcessor"
    fresh = port_model(path)[0].eval()
    fresh.load_state_dict(merged)
    for feed in (back_proc.process_images(eval_set[0]["pos_target"]), back_proc.process_queries(["find the chart"])):
        feed = {k: torch.as_tensor(np.asarray(v)) for k, v in feed.items()}
        with torch.no_grad():
            assert torch.equal(back(**feed), fresh(**feed))


def test_recipe_builds_the_ports_classes_and_trains(synth, tmp_path):
    """``train_colmodernvbert.yaml`` through ``load_config`` (its
    ModernVBERT-base built on the ``meta`` device), the model rebuilt at the
    checkpoint's widths with the checkpoint's weights, and the nodes that
    name absent files replaced by the checkpoint's processor and data."""
    path = synth[3]
    raw = yaml.safe_load((REPO / "configs" / "train_colmodernvbert.yaml").read_text())
    node = raw["config"]
    assert node["model"]["_target_"] == "colpali_tpu.models.ColModernVBert" and node["model"]["scan_layers"]
    node["model"].update(device="meta")
    for key in ("processor", "params", "train_datasets"):
        del node[key]
    (tmp_path / "recipe.yaml").write_text(yaml.safe_dump(raw))
    full = load_config(str(tmp_path / "recipe.yaml"))
    assert type(full["model"]) is tm.ColModernVBert and full["model"].config == tm.ModernVBertConfig()
    assert type(full["loss_func"]) is tlosses.ColbertLoss and full["loss_func"].temperature == 0.02
    assert (full["peft"].rank, full["peft"].alpha, full["peft"].dropout) == (32, 32, 0.1)
    assert (full["train"].learning_rate, full["train"].warmup_steps) == (2e-4, 100)
    model, proc = port_model(path, remat=True)
    app = ColModelTraining(ColModelTrainingConfig(**dict(
        full, model=model, processor=proc, output_dir=str(tmp_path / "out"), global_batch_size=3, log_steps=1,
        report_to="none", device="cpu", max_steps=1, train_datasets=[ColPaliEngineDataset(examples(3))])))
    assert len(app.state.adapters.paths) == 19
    assert app.train()["final_step"] == 1
    app.close()
