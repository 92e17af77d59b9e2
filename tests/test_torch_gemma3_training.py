"""Port parity: LoRA training of the Gemma3 family (ColGemma3, BiGemma3) in
colpali_tpu_torch against colpali_tpu, on the CPU, fp32.

The model is ``tests/test_torch_gemma3.py``'s synthetic Gemma3 cut to 2
text layers (one sliding, one global; window 4, ``query_pre_attn_scalar`` 5
against head dim 8) over 112 px pages pooled to 16 soft tokens, every
weight drawn from a seeded numpy generator and carried into the port by
``core/from_jax.py``. The text attention is the biased path on both sides
(no kernel), so a LoRA step here is the whole of what the card runs but
SigLIP's K6 forward, under a frozen tower.

- The adapted kernels under ``DEFAULT_TARGET_PATTERN`` (``language_model``'s
  q/k/v/o/gate/up/down and ``head/custom_text_proj``) are the paths JAX's
  ``init_lora_params`` picks.
- Two LoRA steps against JAX's own ``make_peft_train_step`` on the port's
  collated batch (queries of unequal lengths, left-padded): ColGemma3 with
  ``ColbertLoss`` (its recipe's, temperature 0.02) and over negatives with
  ``ColbertNegativeCELoss``, the port under remat, each first loss held off
  the value where every page scores alike (:data:`TIED`); BiGemma3
  (``embedding_dim=16``) with ``BiEncoderLoss``. Loss rtol 1e-4, grad norm
  rtol 1e-3, adapters atol 1e-5, as ``tests/test_torch_trainer.py`` holds
  ColPali.
- ``quantize_frozen_base`` stores JAX's layers (the vision tower; the raw
  ``mm_input_projection`` stays float) and the frozen tower records no
  gradient; ``ColModelTraining`` evaluates through a bf16 index and its
  merged export reads back through ``load_retriever(family="colgemma3")``
  bit for bit; ``train_colgemma3.yaml`` and ``train_bigemma3.yaml`` build the
  port's classes through ``configs.load_config`` (their model config and
  the nodes that name absent files replaced), and the ColGemma3 recipe trains.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.models import gemma3 as jg  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu.training import trainer as jtrainer  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.configs import load_config  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax, state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.models import gemma3 as tg  # noqa: E402
from colpali_tpu_torch.models.layers import QDense  # noqa: E402
from colpali_tpu_torch.processors import gemma3 as tpg  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from colpali_tpu_torch.utils.testing import gemma3_word_tokenizer  # noqa: E402
from qwen_lora_oracle import ALPHA, LOSS_RTOL, NORM_RTOL, RANK, TRAIN, assert_adapters, start_adapters  # noqa: E402
from test_torch_gemma3 import IMAGE_TOKEN, TEXT, VISION, configs, seeded_params  # noqa: E402

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
TRAIN_TEXT = dict(TEXT, num_hidden_layers=2)
QUERIES = ("what is the total revenue of the company in the last quarter ?", "a", "find the chart",
           "describe the quarterly report page")
CASES = {"colbert": ("col", jlosses.ColbertLoss, tlosses.ColbertLoss, 0),
         "negatives": ("col", jlosses.ColbertNegativeCELoss, tlosses.ColbertNegativeCELoss, 1),
         "bi": ("bi", jlosses.BiEncoderLoss, tlosses.BiEncoderLoss, 0)}
# the late-interaction losses where every page of a batch of 3 scores alike (ColbertLoss ln 3; the negatives'
# softplus(0) and ln 3 weighted 1:1): a step there compares two gradients that carry no ranking
TIED = {"colbert": np.log(3), "negatives": 0.5 * np.log(2) + 0.5 * np.log(3)}


def examples(n, negatives=0, seed=0):
    """``n`` examples: :data:`QUERIES` in turn, seeded noise pages of three
    shapes, ``negatives`` pages of negatives each."""
    rng = np.random.default_rng(seed)
    shapes = ((150, 120), (90, 200), (112, 112))
    pages = [rng.integers(0, 256, size=(*shapes[i % 3], 3), dtype=np.uint8) for i in range(n * (1 + negatives))]
    return [{"query": QUERIES[i % len(QUERIES)], "pos_target": pages[i],
             **({"neg_target": pages[n + negatives * i: n + negatives * (i + 1)]} if negatives else {})}
            for i in range(n)]


def processor():
    return tpg.ColGemma3Processor(gemma3_word_tokenizer(" ".join(QUERIES).split(), IMAGE_TOKEN), image_size=112,
                                 image_seq_length=16, device="cpu")


@pytest.fixture(scope="module")
def synth():
    """(JAX config, the port's, seeded params, a collated batch)."""
    jcfg, cfg = configs(text=TRAIN_TEXT)
    batch = VisualRetrieverCollator(processor())(examples(3))
    params = seeded_params(jg.ColGemma3(jcfg), [jnp.asarray(np.asarray(batch[f"doc_{k}"]))
                                                 for k in ("input_ids", "attention_mask", "pixel_values")], seed=8)
    return jcfg, cfg, params, batch


def port_model(cfg, params, kind="col", **kw):
    cls = tg.ColGemma3 if kind == "col" else tg.BiGemma3
    model = cls(cfg, device="cpu", **({"embedding_dim": 16} if kind == "bi" else {}), **kw)
    model.load_state_dict(state_dict_from_jax(params if kind == "col" else {"model": params["model"]}))
    return model.train()


def test_adapter_paths_match_init_lora_params(synth):
    _, cfg, params, _ = synth
    want = jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=RANK)
    adapters = LoraAdapters(port_model(cfg, params), SPEC)
    assert sorted(adapters.paths) == sorted(want) and len(adapters.paths) == 7 * TRAIN_TEXT["num_hidden_layers"] + 1
    assert "head/custom_text_proj/kernel" in adapters.paths
    assert all(p.startswith("model/language_model/") for p in adapters.paths if not p.startswith("head/"))
    adapters.detach()


@pytest.mark.parametrize("case", list(CASES))
def test_two_lora_steps_match_jax(synth, case):
    jcfg, cfg, params, _ = synth
    kind, jloss, tloss, negatives = CASES[case]
    batch = VisualRetrieverCollator(processor())(examples(3, negatives=negatives, seed=40))
    mask = np.asarray(batch["query_attention_mask"])
    assert (mask[:, 0] == 0).any() and mask[:, -1].all()  # left padding: pad rows at the start of some queries
    model = port_model(cfg, params, kind, remat=kind == "col")
    base = params if kind == "col" else {"model": params["model"]}
    jmodel = jg.ColGemma3(jcfg) if kind == "col" else jg.BiGemma3(jcfg, embedding_dim=16)
    start = start_adapters(base)
    jspec = jlora.LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
    jstate = jtrainer.create_train_state(jmodel.apply, jax.tree.map(jnp.asarray, start), jtrainer.TrainConfig(**TRAIN))
    jstep = jax.jit(jtrainer.make_peft_train_step(jloss(), jspec, has_negatives=bool(negatives)))
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tloss(), has_negatives=bool(negatives), peft=SPEC)
    jbatch = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
    for i in range(2):
        jstate, want = jstep(jstate, jbatch, base)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        if i == 0 and case in TIED:
            assert abs(got["loss"].item() - TIED[case]) > 0.05, "the pages score alike"
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=NORM_RTOL)
    assert_adapters(adapters, jstate.params, start)
    adapters.detach()


def test_frozen_tower_and_quantized_base_take_jax_layers(synth, tmp_path):
    _, cfg, params, batch = synth
    model = port_model(cfg, params)
    pixels = torch.as_tensor(np.asarray(batch["doc_pixel_values"]))
    assert model.model.image_features(pixels).requires_grad  # nothing is frozen yet
    LoraAdapters(model, SPEC).detach()
    assert not model.model.image_features(pixels).requires_grad

    model = port_model(cfg, params)
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=processor(), loss_func=tlosses.ColbertLoss(), output_dir=str(tmp_path),
        train_datasets=[ColPaliEngineDataset(examples(3))], peft=SPEC, device="cpu", global_batch_size=3,
        quantize_frozen_base=True, quant_min_dim=16, report_to="none"))
    qp, _ = jqd.quantize_params(params, min_dim=16, path_filter=lambda p: "visual" in p or "vision" in p)
    want = sorted("/".join(str(k.key) for k in kp) for kp, leaf in jax.tree_util.tree_leaves_with_path(qp)
                  if leaf.dtype == jnp.int8)
    stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
    assert sorted(app.quantized_paths) == want and len(stored) == 6 * VISION["num_hidden_layers"]
    assert all(n.startswith("model.vision_tower.") for n in stored)
    assert model.model.mm_input_projection.dtype == torch.float32  # the raw projection stays float, as in JAX
    summary = app.train()
    assert summary["final_step"] == 1 and not any(m.weight.grad is not None for m in model.modules()
                                                  if isinstance(m, QDense) and m.stored)
    app.close()


def test_training_run_evaluates_and_exports(synth, tmp_path):
    _, cfg, params, _ = synth
    model = port_model(cfg, params, remat=True)
    eval_set = ColPaliEngineDataset(examples(4, seed=60))
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=processor(), loss_func=tlosses.ColbertLoss(), output_dir=str(tmp_path / "run"),
        train_datasets=[ColPaliEngineDataset(examples(4, seed=50))], eval_dataset=eval_set, global_batch_size=2,
        max_steps=2, log_steps=1, peft=LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.1), report_to="none",
        device="cpu", train=ttrainer.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)))
    losses = []
    app.train(on_step=lambda step, m: losses.append(float(m["loss"])))
    metrics = app.evaluate()
    assert len(losses) == 2 and np.isfinite(losses).all() and np.isfinite(list(metrics.values())).all()
    assert app.eval_index.dtype == "bf16" and app.eval_index.num_docs == 4
    app.save()
    merged = app.state.adapters.merged_state_dict(model)
    app.close()
    back, back_proc = load_retriever(str(tmp_path / "run"), family="colgemma3", dtype=torch.float32, device="cpu")
    assert back.config == cfg and type(back_proc).__name__ == "ColGemma3Processor"
    fresh = port_model(cfg, params).eval()
    fresh.load_state_dict(merged)
    for feed in (back_proc.process_images(eval_set[0]["pos_target"]), back_proc.process_queries(QUERIES)):
        feed = {k: torch.as_tensor(np.asarray(v)) for k, v in feed.items()}
        with torch.no_grad():
            assert torch.equal(back(**feed), fresh(**feed))


def recipe(name, model_cls, tmp_path, cfg, negatives=0):
    """``configs/<name>`` through ``load_config`` (its Gemma3-4B built on
    the ``meta`` device), then the model rebuilt at ``cfg`` on the CPU with
    the recipe's options, and the nodes that name absent files replaced by
    the test's processor and data."""
    raw = yaml.safe_load((REPO / "configs" / name).read_text())
    node = raw["config"]
    assert node["model"]["_target_"] == f"colpali_tpu.models.{model_cls}"
    node["model"].update(device="meta")  # the recipe's full-width Gemma3-4B, never materialised
    for key in ("processor", "params", "train_datasets"):
        del node[key]
    (tmp_path / name).write_text(yaml.safe_dump(raw))
    full = load_config(str(tmp_path / name))
    assert type(full["model"]).__name__ == model_cls and full["model"].config == tg.Gemma3Config()
    data = ColPaliEngineDataset(examples(3, negatives=negatives))
    model = full["model"].__class__(cfg, device="cpu", remat=full["model"].model.language_model.remat)
    return dict(full, model=model, processor=processor(), output_dir=str(tmp_path / "out"), global_batch_size=3,
                log_steps=1, report_to="none", device="cpu", max_steps=1, train_datasets=[data])


@pytest.mark.parametrize("name,model_cls,loss_name", [("train_colgemma3.yaml", "ColGemma3", "ColbertLoss"),
                                                      ("train_bigemma3.yaml", "BiGemma3", "BiEncoderLoss")])
def test_recipes_build_the_ports_classes(synth, tmp_path, name, model_cls, loss_name):
    config = recipe(name, model_cls, tmp_path, synth[1])
    assert type(config["model"]).__name__ == model_cls and config["model"].model.language_model.remat
    assert type(config["loss_func"]).__name__ == loss_name
    if loss_name == "ColbertLoss":
        assert config["loss_func"].temperature == 0.02
    assert (config["peft"].rank, config["peft"].alpha, config["peft"].dropout) == (32, 32, 0.1)
    assert (config["train"].learning_rate, config["train"].warmup_steps) == (2e-4, 100)
    if model_cls == "ColGemma3":
        config["model"].load_state_dict(state_dict_from_jax(synth[2]))
        app = ColModelTraining(ColModelTrainingConfig(**config))
        assert app.train()["final_step"] == 1
        app.close()
