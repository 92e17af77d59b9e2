"""The port's ``ColModelTraining`` on the CPU: the tiny ColPali over the
dummy dataset. Steps, the jsonl log, checkpoints and the export; a resumed
run replays the batch order and the losses of an uninterrupted one
(rtol=1e-6: the same fp32 operations in the same order); ``evaluate()``
gives the metrics that colpali_tpu's evaluator computes from the same
embeddings (equal: ranks of well-separated scores).
"""

import json
import os

import numpy as np
import pytest
import torch

from colpali_tpu.evaluation.evaluator import evaluate_retrieval as jax_evaluate_retrieval
from colpali_tpu_torch.core.hf_loader import load_colpali_params
from colpali_tpu_torch.losses import ColbertPairwiseCELoss
from colpali_tpu_torch.models.common import hf_init_
from colpali_tpu_torch.models.paligemma import ColPali
from colpali_tpu_torch.training import LoraSpec, TrainConfig
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig
from colpali_tpu_torch.utils.testing import DummyProcessor, load_dummy_dataset, tiny_colpali_config

SPEC = LoraSpec(rank=4, alpha=4.0, dropout=0.1)


def build_model(remat=True):
    model = ColPali(tiny_colpali_config(), dim=16, device="cpu", remat=remat)
    return hf_init_(model, torch.Generator().manual_seed(0))


def make_app(output_dir, **overrides):
    kw = dict(
        model=build_model(), loss_func=ColbertPairwiseCELoss(), train_datasets=[load_dummy_dataset(16)],
        processor=DummyProcessor(), eval_dataset=load_dummy_dataset(8, image_size=28), output_dir=str(output_dir),
        global_batch_size=4, max_steps=4, log_steps=1, save_steps=2, peft=SPEC, device="cpu",
        train=TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10),
    )
    kw.update(overrides)
    return ColModelTraining(ColModelTrainingConfig(**kw))


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("full")
    app = make_app(out)
    base_before = {k: v.clone() for k, v in app.model.state_dict().items()}
    seen = []
    summary = app.train(on_step=lambda step, metrics: seen.append((step, float(metrics["loss"]))))
    return app, out, summary, seen, base_before


def test_four_steps_log_and_checkpoint(full_run):
    app, out, summary, seen, base_before = full_run
    assert summary["final_step"] == 4 and [s for s, _ in seen] == [1, 2, 3, 4]
    log = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [e["step"] for e in log] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) and e["loss"] > 0 and e["grad_norm"] > 0 for e in log)
    np.testing.assert_allclose([e["loss"] for e in log], [loss for _, loss in seen], rtol=1e-6)
    assert os.listdir(out / "checkpoints") == ["step_4.pt"]  # save_total_limit=1 keeps the newest
    assert all(torch.equal(v, base_before[k]) for k, v in app.model.state_dict().items())  # the base is frozen
    assert all(float(b.detach().abs().max()) > 0 for b in app.state.adapters.b)


def test_save_writes_merged_weights(full_run):
    app, out, *_ = full_run
    app.save()
    merged = load_colpali_params(str(out))  # model.safetensors in the HF layout, read back by the loader
    assert merged.keys() == app.model.state_dict().keys()
    adapters = app.state.adapters
    name = adapters.module_names[3]
    want = app.model.state_dict()[f"{name}.weight"] + (adapters.a[3] @ adapters.b[3]).T.detach() * (4.0 / 4)
    torch.testing.assert_close(merged[f"{name}.weight"], want)
    assert not torch.equal(merged[f"{name}.weight"], app.model.state_dict()[f"{name}.weight"])
    assert json.load(open(out / "config.json"))["text"]["hidden_size"] == 16
    assert "git_hash" in json.load(open(out / "training_provenance.json"))


def test_resume_replays_the_batch_order_and_the_loss(full_run, tmp_path):
    _, _, _, seen, _ = full_run
    make_app(tmp_path, max_steps=2).train()
    assert os.listdir(tmp_path / "checkpoints") == ["step_2.pt"]
    resumed = make_app(tmp_path, resume_from_checkpoint=True)
    assert resumed.state.step == 2
    tail = []
    summary = resumed.train(on_step=lambda step, metrics: tail.append((step, float(metrics["loss"]))))
    assert summary["final_step"] == 4 and [s for s, _ in tail] == [3, 4]
    np.testing.assert_allclose([loss for _, loss in tail], [loss for _, loss in seen[2:]], rtol=1e-6)
    fresh = make_app(tmp_path / "other")
    all_batches = list(fresh.batches(0))
    skipped = list(fresh.batches(0, skip=2))
    assert len(all_batches) == 4 and len(skipped) == 2
    for a, b in zip(all_batches[2:], skipped):
        np.testing.assert_array_equal(a["doc_pixel_values"], b["doc_pixel_values"])


def test_evaluate_matches_the_jax_evaluator_on_the_same_embeddings(full_run):
    app = full_run[0]
    metrics = app.evaluate()
    assert metrics is app.evaluate()  # cached by train step
    assert set(metrics) == {"eval_loss", "eval_ndcg@1", "eval_recall@1", "eval_mrr@1", "eval_ndcg@5",
                            "eval_recall@5", "eval_mrr@5"}
    assert np.isfinite(list(metrics.values())).all()
    index = app.eval_index
    assert index.dtype == "bf16" and index.num_docs == 8 and index._store.dtype == torch.bfloat16
    docs = index._store.float().permute(0, 2, 1, 3).reshape(-1, index.doc_tokens, index.dim)[:8].numpy()
    want = jax_evaluate_retrieval(app.eval_queries, list(docs), [[i] for i in range(8)], k_values=(1, 5),
                                  index_dtype="bf16")
    for name, value in want.items():
        assert metrics[f"eval_{name}"] == pytest.approx(value, abs=1e-12), name


def test_full_fine_tuning_and_epoch_end_eval(tmp_path):
    app = make_app(tmp_path, peft=None, max_steps=None, num_epochs=1, model=build_model(remat=False),
                   train=TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10))
    before = app.model.head.custom_text_proj.weight.detach().clone()
    summary = app.train()
    assert summary["final_step"] == 4 and "eval_ndcg@5" in summary  # 16 examples / 4, then the epoch's eval
    assert not torch.equal(before, app.model.head.custom_text_proj.weight)
    assert app.state.adapters is None


def test_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        make_app(tmp_path, mesh=object())
    with pytest.raises(NotImplementedError, match="named policies"):
        make_app(tmp_path, remat_policy="dots")
    make_app(tmp_path, remat_policy="full").close()


def test_quantize_frozen_base_stores_only_the_vision_tower_and_needs_lora(tmp_path):
    with pytest.raises(ValueError, match="peft"):
        make_app(tmp_path, peft=None, quantize_frozen_base=True)
    app = make_app(tmp_path, quantize_frozen_base=True, quant_min_dim=16)
    stored = {name for name, m in app.model.named_modules() if getattr(m, "stored", False)}
    assert stored and all(name.startswith("model.vision_tower.") for name in stored)
    assert len(app.quantized_paths) == len(stored)
    app.close()


def test_cli_trains_from_yaml(tmp_path):
    pytest.importorskip("yaml")
    from colpali_tpu_torch import train as cli

    config = tmp_path / "config.yaml"
    config.write_text(f"""
config:
  model:
    _target_: colpali_tpu_torch.models.paligemma.ColPali
    config: {{_target_: colpali_tpu_torch.utils.testing.tiny_colpali_config}}
    dim: 16
    device: cpu
    remat: true
  processor: {{_target_: colpali_tpu_torch.utils.testing.DummyProcessor}}
  loss_func: {{_target_: colpali_tpu_torch.losses.ColbertLoss}}
  train_datasets:
    - {{_target_: colpali_tpu_torch.utils.testing.load_dummy_dataset, n: 8}}
  peft: {{_target_: colpali_tpu_torch.training.LoraSpec, rank: 2, alpha: 2, dropout: 0.0}}
  output_dir: {tmp_path / "run"}
  global_batch_size: 4
  log_steps: 1
  device: cpu
  train: {{_target_: colpali_tpu_torch.training.TrainConfig, learning_rate: 1.0e-3, warmup_steps: 0, total_steps: 2}}
""")
    summary = cli.main([str(config)])
    assert summary["final_step"] == 2
    assert {"model.safetensors", "training_config.yml", "metrics.jsonl"} <= set(os.listdir(tmp_path / "run"))
