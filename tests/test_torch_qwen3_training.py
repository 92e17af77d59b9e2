"""Port parity: LoRA training of ColQwen3 and BiQwen3 in colpali_tpu_torch
against colpali_tpu, on the CPU, fp32, on a tiny checkpoint (the widths of
``scripts/gate_families.py``'s ``make_synth_colqwen3``: vision 2 x 32 with
deepstack after both blocks, text 2 x 48, GQA 4/2 x 12) that the port
writes (``utils.testing.write_qwen3_checkpoint``, every weight then moved by
seeded noise) and each package's ``load_retriever`` reads. The oracle is
JAX's step composed around a keyword forward (``tests/qwen_lora_oracle.py``):
the JAX trainer's ``_forward`` drops the pages' geometry and taps.

- ``VisualRetrieverCollator`` with image negatives against JAX's, with and
  without padding targets: integers exactly, pixels at 1e-4, ``pos_idx``
  and ``pos_weight`` JAX's then zeros where JAX leaves them unpadded.
- The adapted kernels are the paths JAX's ``init_lora_params`` picks.
- Two LoRA steps of ColQwen3 (``ColbertLoss(temperature=0.02)``, and
  ``ColbertNegativeCELoss`` over image negatives) and of BiQwen3
  (``BiEncoderLoss``) against JAX's: loss rtol 1e-4, grad norm rtol 1e-3,
  adapters atol 1e-5, as ``tests/test_torch_trainer.py`` holds ColPali;
  every step's loss away from the value of a batch whose pages all score
  alike.
- ``remat`` gives the same gradients bit for bit.
- ``configs/train_colqwen3.yaml`` through ``load_config`` builds the port's
  classes (its Qwen3-VL-4B on ``meta``), and ``ColModelTraining`` over a
  ``quantize_frozen_base`` tower stores JAX's vision layers, the deepstack
  mergers among them, and trains with no gradient through them.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator  # noqa: E402
from colpali_tpu.models import qwen3_vl as jq  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.configs import load_config  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colqwen3_state_dict  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.models import qwen3_vl as tq  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from colpali_tpu_torch.utils.testing import write_qwen3_checkpoint  # noqa: E402
from qwen_lora_oracle import (  # noqa: E402
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    QUERIES,
    RANK,
    TRAIN,
    JaxOracle,
    assert_adapters,
    assert_collated_like_jax,
    examples,
    start_adapters,
)

REPO = Path(__file__).resolve().parents[1]
SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
CONFIG = tq.Qwen3VLConfig(
    vision=tq.Qwen3VLVisionConfig(depth=2, hidden_size=32, num_heads=4, intermediate_size=64, out_hidden_size=48,
                                  patch_size=14, num_position_embeddings=16, deepstack_visual_indexes=(0, 1)),
    text=tq.Qwen3TextConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, head_dim=12, mrope_section=(2, 2, 2)))
CASES = {"colbert": ("col", jlosses.ColbertLoss, tlosses.ColbertLoss, 0),
         "negatives": ("col", jlosses.ColbertNegativeCELoss, tlosses.ColbertNegativeCELoss, 2),
         "bi": ("bi", jlosses.BiEncoderLoss, tlosses.BiEncoderLoss, 0)}
# the losses where every page of a batch of 3 scores alike (ColbertLoss ln 3; the negatives' softplus(0) and ln 3
# weighted 1:1; BiEncoderLoss ln 3): a step there compares two gradients that carry no ranking
TIED = {"colbert": np.log(3), "negatives": 0.5 * np.log(2) + 0.5 * np.log(3), "bi": np.log(3)}


def vision_path(p: str) -> bool:
    return "visual" in p or "vision" in p


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, variables, JAX processor, checkpoint dir), fp32."""
    path = tmp_path_factory.mktemp("synth") / "colqwen3"
    write_qwen3_checkpoint(str(path), CONFIG, seed=0, words=" ".join(QUERIES).split(), device="cpu")
    pp = json.loads((path / "preprocessor_config.json").read_text())
    pp["size"]["shortest_edge"] = 56 * 56  # small pages, within the tiny tests' budget of 64 merged tokens
    (path / "preprocessor_config.json").write_text(json.dumps(pp))
    model, _ = load_retriever(str(path), family="colqwen3", dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)  # every weight off its initial value (norms at 1, biases at 0)
    state = {k: v + torch.randn(v.shape, generator=gen) * 0.05 for k, v in model.state_dict().items()}
    safetensors.save_file(export_colqwen3_state_dict(state, patch_size=14), str(path / "model.safetensors"))
    return (*jax_load_retriever(str(path), dtype=jnp.float32, param_dtype=jnp.float32,
                                processor_kwargs={"max_num_visual_tokens": 64}), str(path))


def port_model(path, remat=False):
    model, proc = load_retriever(path, family="colqwen3", dtype=torch.float32, device="cpu", remat=remat,
                                 processor_kwargs={"max_num_visual_tokens": 64})
    return model.train(), proc


@pytest.mark.parametrize("padded", [False, True])
def test_collator_batches_match_jax(synth, padded):
    jproc, path = synth[2], synth[3]
    pad = dict(pad_seq_to=[96, 160], pad_patches_to=[288, 384]) if padded else {}
    batch = examples(2, negatives=2)
    got = VisualRetrieverCollator(port_model(path)[1], **pad)(batch)
    assert_collated_like_jax(got, JaxCollator(jproc, device_pixels=False, **pad)(batch), padded)
    assert got["neg_doc_pos_idx"].shape[:2] == (2, 2) and got["doc_pos_weight"].shape[-1] == 4
    if padded:
        assert got["doc_pos_idx"].shape[1] == got["doc_patch_mask"].shape[1] == 288


def test_adapter_paths_match_init_lora_params(synth):
    variables, path = synth[1], synth[3]
    model = port_model(path)[0]
    want = jlora.init_lora_params(variables["params"], jax.random.PRNGKey(1), rank=RANK)
    paths = LoraAdapters(model, SPEC).paths
    assert sorted(paths) == sorted(want) and not any(vision_path(p) for p in paths)
    assert len(paths) == 7 * model.config.text.num_hidden_layers + 1  # q/k/v/o/gate/up/down, the head


@pytest.mark.parametrize("case", list(CASES))
def test_lora_steps_match_jax(synth, case):
    jmodel, variables, _, path = synth
    kind, jloss, tloss, negatives = CASES[case]
    col, proc = port_model(path)
    if kind == "bi":
        model = tq.BiQwen3(col.config, device="cpu").train()
        model.load_state_dict({k: v for k, v in col.state_dict().items() if k.startswith("model.")})
        jmodel, base = jq.BiQwen3(jmodel.config), {"model": variables["params"]["model"]}
    else:
        model, base = col, variables["params"]
    start = start_adapters(base)
    batch = VisualRetrieverCollator(proc)(examples(3, negatives=negatives, seed=40 + negatives))
    oracle = JaxOracle(jmodel, base, start, jloss(), negatives > 0)
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(start)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tloss(), has_negatives=negatives > 0, peft=SPEC)
    for _ in range(2):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
        assert abs(got["loss"].item() - TIED[case]) > 1e-3, (got["loss"].item(), TIED[case])
    assert_adapters(adapters, oracle.lora, start)


def test_remat_gives_the_same_gradients(synth):
    batch, grads = None, []
    for remat in (False, True):
        model, proc = port_model(synth[3], remat=remat)
        batch = batch or ttrainer.to_device(VisualRetrieverCollator(proc)(examples(2, seed=30)), "cpu")
        loss, _, _ = ttrainer.compute_loss(model, batch, tlosses.ColbertLoss(), False)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and any("deepstack_merger" in n for n in grads[0])
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_recipe_builds_the_ports_classes_and_trains_over_an_int8_tower(synth, tmp_path):
    """``configs/train_colqwen3.yaml`` through ``load_config`` (its
    Qwen3-VL-4B on ``meta``, never materialised), then the tiny model with
    the recipe's options through ``ColModelTraining(quantize_frozen_base=
    True)``: JAX's ``quantize_params(path_filter=vision)`` layers, one step,
    no gradient through the int8 tower."""
    variables, path = synth[1], synth[3]
    raw = yaml.safe_load((REPO / "configs" / "train_colqwen3.yaml").read_text())
    node = raw["config"]
    assert node["model"]["_target_"] == "colpali_tpu.models.ColQwen3" and node["model"]["scan_layers"] is True
    node["model"].update(device="meta")
    for key in ("processor", "params", "train_datasets"):
        del node[key]
    (tmp_path / "recipe.yaml").write_text(yaml.safe_dump(raw))
    full = load_config(str(tmp_path / "recipe.yaml"))
    recipe_model = full["model"]
    assert type(recipe_model) is tq.ColQwen3 and recipe_model.config == tq.Qwen3VLConfig()
    assert recipe_model.head.custom_text_proj.out_features == 320 and recipe_model.model.language_model.remat
    assert type(full["loss_func"]) is tlosses.ColbertLoss and full["loss_func"].temperature == 0.02
    assert (full["peft"].rank, full["peft"].alpha, full["peft"].dropout) == (32, 32, 0.1)

    model, proc = port_model(path, remat=True)
    app = ColModelTraining(ColModelTrainingConfig(**dict(
        full, model=model, processor=proc, train_datasets=[ColPaliEngineDataset(examples(4, seed=20))],
        global_batch_size=2, max_steps=1, output_dir=str(tmp_path / "run"), log_steps=1, save_steps=100,
        report_to="none", device="cpu", quantize_frozen_base=True, quant_min_dim=32)))
    qparams, _ = jqd.quantize_params(variables["params"], min_dim=32, path_filter=vision_path)
    want = sorted("/".join(str(k.key) for k in p) for p, x in jax.tree_util.tree_flatten_with_path(qparams)[0]
                  if x.dtype == jnp.int8)
    assert sorted(app.quantized_paths) == want and any("deepstack_merger_1" in p for p in want)
    losses = []
    app.train(on_step=lambda step, m: losses.append(m["loss"].item()))
    assert len(losses) == 1 and np.isfinite(losses[0])
    feed = ttrainer.to_device(next(iter(app.batches(0))), "cpu")
    merged, taps = model.model.visual(*(feed[f"doc_{k}"] for k in ("pixel_values", "vision_hpos", "vision_wpos",
                                                                    "patch_mask", "pos_idx", "pos_weight")))
    assert not merged.requires_grad and not any(t.requires_grad for t in taps)
    app.close()
