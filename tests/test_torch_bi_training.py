"""Port parity: LoRA training of the single-vector (Bi) models in
colpali_tpu_torch against colpali_tpu, on the CPU, fp32, JAX's attention on
its einsum route (no Pallas).

- ``BiIdefics3`` (2 + 2 layers, head dim 12, pages of 13, 7 and 1 tiles)
  with ``BiEncoderLoss``, its recipe's loss; the queries have unequal
  lengths and the processor pads on the right, so ``last`` pooling reads a
  pad row of the shorter ones, whose gradient reaches the valid keys
  through the keys' own ids. ``BiPali`` (the tiny ColPali widths) with
  ``BiPairwiseCELoss``, and ``BiQwen2_5`` (``tests/qwen_lora_oracle.py``'s
  checkpoint and its keyword forward) over image negatives with
  ``BiNegativeCELoss``, and ``BiQwen3_5`` (Qwen3.5's hybrid decoder at
  ``make_synth_colqwen35``'s widths, written by ``write_qwen35_checkpoint``)
  with ``BiEncoderLoss``. Each: the adapted kernels are the paths JAX's
  ``init_lora_params`` picks, and two LoRA steps match JAX's at loss rtol
  1e-4, grad norm rtol 1e-3, adapters atol 1e-5, as
  ``tests/test_torch_trainer.py`` holds ColPali. ``BiIdefics3`` and
  ``BiPali`` go through JAX's own ``make_peft_train_step``.
- ``ColModelTraining.evaluate()`` ranks multi-vector embeddings only: on a
  Bi model JAX's ``evaluate`` raises an IndexError (it indexes a ``(D,)``
  vector with an ``(S,)`` query mask), and the port refuses the model with
  a ValueError that says why, never a result.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu import losses as jlosses
from colpali_tpu.auto import load_retriever as jax_load_retriever
from colpali_tpu.core.hf_loader import load_colidefics3_params
from colpali_tpu.models import idefics3 as ji
from colpali_tpu.models import paligemma as jp
from colpali_tpu.models import qwen2_5_vl as jq25
from colpali_tpu.models import qwen2_vl as jq
from colpali_tpu.training import lora as jlora
from colpali_tpu.training import trainer as jtrainer
from colpali_tpu.training.orchestrator import ColModelTraining as JaxColModelTraining
from colpali_tpu.utils.testing import tiny_colpali_config as jax_tiny_colpali_config
from colpali_tpu_torch import losses as tlosses
from colpali_tpu_torch.auto import load_retriever
from colpali_tpu_torch.core.from_jax import lora_from_jax, state_dict_from_jax
from colpali_tpu_torch.data.collator import VisualRetrieverCollator
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset
from colpali_tpu_torch.models import idefics3 as ti
from colpali_tpu_torch.models import paligemma as tp
from colpali_tpu_torch.models import qwen2_5_vl as tq25
from colpali_tpu_torch.processors import bi
from colpali_tpu_torch.training import trainer as ttrainer
from colpali_tpu_torch.training.checkpointing import save_pretrained
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig
from colpali_tpu_torch.utils.testing import (
    DummyProcessor,
    IDEFICS3_TRAIN_QUERIES,
    idefics3_training_examples,
    idefics3_word_tokenizer,
    tiny_colpali_config,
    tiny_idefics3_config,
)
from qwen_lora_oracle import (
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    RANK,
    TRAIN,
    JaxOracle,
    assert_adapters,
    examples,
    start_adapters,
    write_checkpoint,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
QWEN35_GRAD_RTOL_RMS = 2e-2  # BiQwen3_5's adapter gradients against JAX's per leaf (see its test)
PALI_QUERIES = ("what is the total revenue ?", "a", "find the quarterly report of the company", "chart")


def jbatch(batch):
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}


def jax_and_port(jax_model, port_model, batch, prefix="doc_"):
    """JAX's init on a sub-batch, its params carried into the port's model."""
    feed = [jnp.asarray(np.asarray(batch[f"{prefix}{k}"])) for k in ("input_ids", "attention_mask", "pixel_values")]
    params = jax.tree.map(np.asarray, jax.jit(jax_model.init)(jax.random.PRNGKey(0), *feed)["params"])
    port_model.load_state_dict(state_dict_from_jax(params))
    return params, port_model.train()


@pytest.fixture(scope="module")
def biidefics3(tmp_path_factory):
    """A BiIdefics3 at ``tiny_idefics3_config(head_dim=12)`` with the port's
    seeded initialization, written as an HF checkpoint that JAX's
    ``load_colidefics3_params`` reads (no JAX init to compile)."""
    cfg = tiny_idefics3_config(head_dim=12)
    jax_cfg = ji.Idefics3Config(vision=ji.Idefics3VisionConfig(**dataclasses.asdict(cfg.vision)),
                                text=jq.Qwen2TextConfig(**dataclasses.asdict(cfg.text)),
                                scale_factor=cfg.scale_factor, image_token_id=cfg.image_token_id)
    words = " ".join(IDEFICS3_TRAIN_QUERIES).split()
    proc = bi.BiIdefics3Processor(idefics3_word_tokenizer(words), tile_size=64, longest_edge=256, image_seq_len=4,
                                  device="cpu")
    batch = VisualRetrieverCollator(proc)(idefics3_training_examples(4, seed=70))
    mask = np.asarray(batch["query_attention_mask"])
    assert (mask[:, -1] == 0).sum() == 3 and np.asarray(batch["doc_tile_mask"]).sum(1).tolist() == [13, 7, 1, 13]
    with torch.random.fork_rng():
        torch.manual_seed(70)
        model = ti.BiIdefics3(cfg, device="cpu", remat=True)
    path = str(tmp_path_factory.mktemp("biidefics3"))
    save_pretrained(path, model.state_dict(), config=cfg)
    params = jax.tree.map(np.asarray, {"model": load_colidefics3_params(path)["model"]})
    model.load_state_dict(state_dict_from_jax(params))  # the same weights, through both packages' layouts
    return ji.BiIdefics3(jax_cfg), params, model.train(), batch, jlosses.BiEncoderLoss, tlosses.BiEncoderLoss


@pytest.fixture(scope="module")
def bipali():
    proc = DummyProcessor()
    rng = np.random.default_rng(71)
    data = [{"query": q, "pos_target": rng.integers(0, 256, size=(40, 30, 3), dtype=np.uint8)} for q in PALI_QUERIES]
    batch = VisualRetrieverCollator(proc)(data)
    params, model = jax_and_port(jp.BiPali(jax_tiny_colpali_config()), tp.BiPali(tiny_colpali_config(), device="cpu"),
                                 batch)
    return jp.BiPali(jax_tiny_colpali_config()), params, model, batch, jlosses.BiPairwiseCELoss, \
        tlosses.BiPairwiseCELoss


@pytest.mark.parametrize("family", ["biidefics3", "bipali"])
def test_two_lora_steps_match_jax(family, request):
    jmodel, params, model, batch, jloss, tloss = request.getfixturevalue(family)
    want_paths = jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=RANK)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(want_paths) and not any("head" in p for p in adapters.paths)
    start = start_adapters(params)
    adapters.load_tree(lora_from_jax(start))
    jspec = jlora.LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
    jstate = jtrainer.create_train_state(jmodel.apply, jax.tree.map(jnp.asarray, start), jtrainer.TrainConfig(**TRAIN))
    jstep = jax.jit(jtrainer.make_peft_train_step(jloss(), jspec))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tloss(), peft=SPEC)
    for _ in range(2):
        jstate, want = jstep(jstate, jbatch(batch), params)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=NORM_RTOL)
    assert_adapters(adapters, jstate.params, start)
    adapters.detach()


def test_biqwen2_5_lora_steps_over_negatives_match_jax(tmp_path):
    path = str(tmp_path / "colqwen2_5")
    # the module's own initialization draws from the global generator before write_checkpoint's seeded noise: a
    # fixed checkpoint, so that no adapter entry's gradient sits near Adam's eps in one run and not in another
    torch.manual_seed(0)
    write_checkpoint(path, "colqwen2_5")
    jcol, variables, _ = jax_load_retriever(path, dtype=jnp.float32, param_dtype=jnp.float32)
    col, proc = load_retriever(path, family="colqwen2_5", dtype=torch.float32, device="cpu")
    model = tq25.BiQwen2_5(col.config, device="cpu").train()
    model.load_state_dict({k: v for k, v in col.state_dict().items() if k.startswith("model.")})
    base = {"model": variables["params"]["model"]}
    start = start_adapters(base)
    batch = VisualRetrieverCollator(proc)(examples(3, negatives=1, seed=72))
    oracle = JaxOracle(jq25.BiQwen2_5(jcol.config), base, start, jlosses.BiNegativeCELoss(), True)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tlosses.BiNegativeCELoss(), has_negatives=True, peft=SPEC)
    for _ in range(2):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
    assert_adapters(adapters, oracle.lora, start)


def test_biqwen3_5_lora_steps_match_jax(tmp_path):
    """BiQwen3_5 (``last`` pooling over Qwen3.5's hybrid decoder: a period of three GatedDeltaNet layers and one
    gated attention layer, MoE on every layer) written by ``write_qwen35_checkpoint`` at the tiny widths of
    ``make_synth_colqwen35`` and read by both packages; two LoRA steps with ``BiEncoderLoss`` against JAX's keyword
    forward: loss, grad norm and adapters at ``tests/qwen_lora_oracle.py``'s tolerances; each leaf's adapter
    gradient within 2e-2 of its RMS and an entry whose JAX gradient lies within that of 0 held to the Adam steps'
    bound (``tests/test_torch_qwen2_training.py``'s rule). This checkpoint's draws (HF Qwen3-Next's: ``A_log``
    from log U(1, 16)) leave GatedDeltaNet heads of small RMS, whose per-head RMSNorm scales the packages' fp32
    rounding up: 1.07e-2 of a leaf's RMS was read on BiQwen3_5 and 1.0e-2 on ColQwen3_5 over the same
    checkpoint (the losses 7e-6 apart), where ``make_synth_colqwen35``'s draws hold 1e-3."""
    import json

    from colpali_tpu.core.hf_loader import load_colqwen35_params
    from colpali_tpu.models import qwen3_5 as jq35
    from colpali_tpu_torch.models import qwen3_5 as tq35
    from colpali_tpu_torch.models.qwen3_vl import Qwen3VLVisionConfig
    from colpali_tpu_torch.utils.testing import write_qwen35_checkpoint
    from qwen_lora_oracle import QUERIES, recording_gradients

    config = tq35.Qwen35VLConfig(
        vision=Qwen3VLVisionConfig(depth=2, hidden_size=32, num_heads=4, intermediate_size=64, out_hidden_size=48,
                                   patch_size=14, num_position_embeddings=16, deepstack_visual_indexes=(0, 1)),
        text=tq35.Qwen35TextConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=4, num_attention_heads=4,
                                   num_key_value_heads=2, head_dim=16, linear_num_value_heads=4,
                                   linear_num_key_heads=2, linear_key_head_dim=8, linear_value_head_dim=8,
                                   linear_conv_kernel_dim=2, num_experts=4, num_experts_per_tok=2,
                                   moe_intermediate_size=32, shared_expert_intermediate_size=32))
    path = tmp_path / "colqwen3_5"
    write_qwen35_checkpoint(str(path), config, seed=7, words=" ".join(QUERIES).split(), device="cpu")
    pp = json.loads((path / "preprocessor_config.json").read_text())
    pp["size"]["shortest_edge"] = 56 * 56  # small pages
    (path / "preprocessor_config.json").write_text(json.dumps(pp))
    col, proc = load_retriever(str(path), family="colqwen3_5", dtype=torch.float32, device="cpu",
                               processor_kwargs={"max_num_visual_tokens": 64})
    model = tq35.BiQwen3_5(col.config, device="cpu").train()
    model.load_state_dict({k: v for k, v in col.state_dict().items() if k.startswith("model.")})
    jcfg = jq35.Qwen35VLConfig.from_hf_config(json.loads((path / "config.json").read_text()))
    base = {"model": jax.tree.map(np.asarray, load_colqwen35_params(str(path))["model"])}
    start = start_adapters(base)
    batch = VisualRetrieverCollator(proc)(examples(3, seed=73))
    oracle = JaxOracle(jq35.BiQwen3_5(jcfg, dtype=jnp.float32, param_dtype=jnp.float32), base, start,
                       jlosses.BiEncoderLoss(), False)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start) and len(start) == 4 + 3 * 4
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tlosses.BiEncoderLoss(), peft=SPEC)
    grads = recording_gradients(state)
    near_eps = {p: {n: np.zeros(v.shape, bool) for n, v in ab.items()} for p, ab in start.items()}
    for _ in range(2):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
        for p, ab in grads[-1].items():
            for name, g in ab.items():
                w = oracle.grads[p][name]
                noise = QWEN35_GRAD_RTOL_RMS * np.sqrt(np.mean(np.square(w)))
                assert np.abs(g - w).max() <= noise, f"{p}/{name}"
                near_eps[p][name] |= np.abs(w) < noise
    lr_sum = sum(ttrainer.learning_rate_at(state.config, count) for count in range(state.step))
    assert_adapters(adapters, oracle.lora, start, near_eps, step_bound=2 * lr_sum)


def test_single_vector_evaluate_is_refused_where_jax_fails(bipali, tmp_path):
    model, batch, tloss = bipali[2], bipali[3], bipali[5]
    with torch.no_grad():  # the port's BiPali, which the steps above hold to JAX's
        q = model(*(torch.as_tensor(np.asarray(batch[f"query_{k}"])) for k in ("input_ids", "attention_mask"))).numpy()
    assert q.ndim == 2 and q.shape[1] != batch["query_attention_mask"].shape[1]
    jax_self = types.SimpleNamespace(state=types.SimpleNamespace(step=0), base_params=None, _eval_batches=[batch],
                                     config=types.SimpleNamespace(eval_dataset=None, eval_batch_size=4),
                                     _eval_relevance=[[i] for i in range(len(q))], _device_batch=lambda b: b,
                                     eval_step=lambda state, b: (jnp.zeros(()), q, q))
    with pytest.raises(IndexError):
        JaxColModelTraining.evaluate(jax_self)
    data = ColPaliEngineDataset([{"query": t, "pos_target": np.zeros((28, 28, 3), np.uint8)} for t in PALI_QUERIES])
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=DummyProcessor(), loss_func=tloss(), train_datasets=[data], eval_dataset=data,
        output_dir=str(tmp_path), global_batch_size=4, peft=SPEC, report_to="none", device="cpu"))
    with pytest.raises(ValueError, match="single vectors"):
        app.evaluate()
    app.close()
