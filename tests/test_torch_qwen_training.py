"""Port parity: LoRA training of ColQwen2.5 in colpali_tpu_torch against
colpali_tpu, on the CPU, fp32, on a tiny checkpoint (vision 2 x 64 with a
windowed and a full block, text 2 x 48, GQA 4/2) that the port writes and
each package's ``load_retriever`` reads. The oracle is JAX's step composed from its own pieces
(``tests/qwen_lora_oracle.py``).

- ``VisualRetrieverCollator`` on the processor's batches with image
  negatives against JAX's, with and without padding targets
  (``assert_collated_like_jax``: integers exactly, pixels at 1e-4,
  ``window_id`` padded with -1 where JAX leaves it unpadded).
- The adapted kernels under ``DEFAULT_TARGET_PATTERN`` are the paths JAX's
  ``init_lora_params`` picks, and ``lora_from_jax`` carries its adapters.
- Three LoRA steps with image negatives against JAX's step: loss rtol
  1e-4, grad norm rtol 1e-3, adapters atol 1e-5, as
  ``tests/test_torch_trainer.py`` holds ColPali.
- ``ColModelTraining(quantize_frozen_base=True)``: the layers and int8
  values of JAX's ``quantize_params(path_filter=vision)`` bit for bit; two
  steps against JAX's step over that base with ``ColbertLoss(temperature=
  1)``, loss and grad norm at rtol 1e-3 (an activation an ulp from an int8
  rounding boundary may round the other way, see ``QUANT_RTOL``); no
  gradient recorded through the int8 tower;
  the merged export against JAX's ``dequantize_params`` + ``merge_lora`` of
  the same adapters (the tower's ``q * scale`` bit for bit, the adapted
  weights at 1e-6, the rank-r product's sums in another order), read back
  by ``load_retriever`` bit for bit.
- ``remat`` gives the same gradients bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.core.hf_export import export_colqwen25_state_dict as jax_export  # noqa: E402
from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as tqd  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig  # noqa: E402
from qwen_lora_oracle import (  # noqa: E402
    ALPHA,
    LOSS_RTOL,
    NORM_RTOL,
    RANK,
    TRAIN,
    JaxOracle,
    assert_adapters,
    assert_collated_like_jax,
    examples,
    start_adapters,
    write_checkpoint,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
QUANT_MIN_DIM = 32  # the tiny tower's projections (48 to 1,176 wide) all quantize
STEPS = 3
# the quantized tower against JAX's: an activation that lies an fp32 ulp from an int8 rounding boundary may
# round the other way (the fp32 sums before it run in another order, and the port's CPU sums are not the same
# from run to run), which the quantized forward of test_torch_qwen2_5_vl.py is held per token for. Under the
# recipe's temperature 0.02 one such flip moved the loss by up to 2e-3 relative (2 of 5 runs here); at
# temperature 1 by up to 1.1e-4 (1 of 8 runs; 1e-7 without a flip). The loss and the gradient norm are held at
# temperature 1, at 1e-3
QUANT_TEMPERATURE, QUANT_RTOL = 1.0, 1e-3


def vision_path(p: str) -> bool:
    return "visual" in p or "vision" in p


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, variables, JAX processor, checkpoint dir), fp32."""
    path = str(tmp_path_factory.mktemp("synth") / "colqwen2_5")
    write_checkpoint(path, "colqwen2_5")
    return (*jax_load_retriever(path, dtype=jnp.float32, param_dtype=jnp.float32), path)


def port_model(path, remat=False):
    model, proc = load_retriever(path, family="colqwen2_5", dtype=torch.float32, device="cpu", remat=remat)
    return model.train(), proc


@pytest.mark.parametrize("padded", [False, True])
def test_collator_batches_match_jax(synth, padded):
    jproc, path = synth[2], synth[3]
    pad = dict(pad_seq_to=[96, 160], pad_patches_to=[192, 256]) if padded else {}
    batch = examples(2, negatives=2)
    got = VisualRetrieverCollator(port_model(path)[1], **pad)(batch)
    assert_collated_like_jax(got, JaxCollator(jproc, device_pixels=False, **pad)(batch), padded)
    assert got["neg_doc_pixel_values"].shape[:2] == (2, 2) and got["neg_doc_window_id"].shape[:2] == (2, 2)
    assert got["neg_doc_position_ids"].shape[:2] == (3, 4)  # (3, B * n, S), as JAX's collator leaves it
    if padded:
        assert got["doc_input_ids"].shape[-1] == 96 and got["neg_doc_patch_mask"].shape[-1] == 192


def test_adapter_paths_match_init_lora_params(synth):
    variables, path = synth[1], synth[3]
    model = port_model(path)[0]
    want = jax.tree.map(np.asarray, jlora.init_lora_params(variables["params"], jax.random.PRNGKey(1), rank=RANK))
    adapters = LoraAdapters(model, SPEC)
    assert sorted(adapters.paths) == sorted(want)
    assert len(adapters.paths) == 7 * model.config.text.num_hidden_layers + 1  # q/k/v/o/gate/up/down, the head
    assert not any(vision_path(p) for p in adapters.paths)
    adapters.load_tree(lora_from_jax(want))
    for p, ab in adapters.tree().items():
        assert np.array_equal(ab["a"].numpy(), want[p]["a"]) and np.array_equal(ab["b"].numpy(), want[p]["b"])


def test_lora_steps_with_negatives_match_jax(synth):
    jmodel, variables, _, path = synth
    model, proc = port_model(path)
    start = start_adapters(variables["params"])
    batch = VisualRetrieverCollator(proc)(examples(2, negatives=2, seed=10))
    oracle = JaxOracle(jmodel, variables["params"], start, jlosses.ColbertNegativeCELoss(), True)
    adapters = LoraAdapters(model, SPEC)
    adapters.load_tree(lora_from_jax(start))
    state = ttrainer.create_train_state(model, ttrainer.TrainConfig(**TRAIN), adapters)
    step = ttrainer.make_train_step(tlosses.ColbertNegativeCELoss(), has_negatives=True, peft=SPEC)
    for _ in range(STEPS):
        want_loss, want_norm = oracle.step(batch)
        got = step(state, ttrainer.to_device(batch, "cpu"))
        np.testing.assert_allclose(got["loss"].item(), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"].item(), want_norm, rtol=NORM_RTOL)
    assert want_norm > TRAIN["max_grad_norm"]  # the clip was active
    assert_adapters(adapters, oracle.lora, start)


def test_quantized_frozen_base_trains_and_exports_as_jax(synth, tmp_path):
    jmodel, variables, _, path = synth
    model, proc = port_model(path)
    loss_fn = dict(temperature=QUANT_TEMPERATURE)
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=proc, loss_func=tlosses.ColbertLoss(**loss_fn),
        train_datasets=[ColPaliEngineDataset(examples(4, seed=20))], global_batch_size=2, max_steps=2, peft=SPEC,
        train=ttrainer.TrainConfig(**TRAIN), device="cpu", quantize_frozen_base=True,
        quant_min_dim=QUANT_MIN_DIM, output_dir=str(tmp_path / "run"), report_to="none", save_steps=100))
    qparams, qc = jqd.quantize_params(variables["params"], min_dim=QUANT_MIN_DIM, path_filter=vision_path)
    assert len(app.quantized_paths) == sum(x.dtype == jnp.int8 for x in jax.tree.leaves(qparams)) > 8
    assert all(vision_path(p) for p in app.quantized_paths)
    tower = model.model.visual
    want_q = np.asarray(qparams["model"]["visual"]["patch_embed"]["kernel"]).T
    assert tower.patch_embed.stored and np.array_equal(tower.patch_embed.weight.numpy(), want_q)

    start = start_adapters(variables["params"])
    app.state.adapters.load_tree(lora_from_jax(start))
    batches = list(app.batches(0))
    oracle = JaxOracle(jmodel, qparams, start, jlosses.ColbertLoss(**loss_fn), False, quant=qc)
    want = [oracle.step(b) for b in batches]
    got = []
    app.train(on_step=lambda step, m: got.append((m["loss"].item(), m["grad_norm"].item())))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=QUANT_RTOL)
    for b in app.state.adapters.b:
        assert b.detach().abs().max() > 0  # every adapter moved
    feed = ttrainer.to_device(batches[0], "cpu")
    feats = tower(*(feed[f"doc_{k}"] for k in ("pixel_values", "vision_hpos", "vision_wpos", "patch_mask", "window_id")))
    assert not feats.requires_grad  # the int8 tower records no gradient

    out = str(tmp_path / "export")
    app.save(out)  # the port's adapters, exported beside JAX's merge of the same adapters
    port_lora = {p: {k: v.numpy() for k, v in ab.items()} for p, ab in app.state.adapters.tree().items()}
    merged = jlora.merge_lora(jqd.dequantize_params(qparams, qc), port_lora, alpha=ALPHA, rank=RANK)
    want_state = {k: np.asarray(v) for k, v in jax_export(jax.device_get(merged)).items()}
    got_state = {k: v.numpy() for k, v in safetensors.load_file(f"{out}/model.safetensors").items()}
    assert set(got_state) == set(want_state)
    for key, w in want_state.items():
        if "visual" in key:  # q * scale in fp32: the int8 values and scales bit for bit
            assert np.array_equal(got_state[key], w), key
        else:  # W + (alpha/r) A @ B: the rank-r product's sums in another order
            np.testing.assert_allclose(got_state[key], w, atol=1e-6, rtol=0, err_msg=key)
    back, back_proc = load_retriever(out, family="colqwen2_5", dtype=torch.float32, device="cpu")
    in_memory = tqd.dequantize_state_dict(app.state.adapters.merged_state_dict(model), torch.float32)
    assert back_proc.window_size == proc.window_size and back.state_dict().keys() == in_memory.keys()
    for key, value in back.state_dict().items():
        assert torch.equal(value, in_memory[key]), key
    app.close()


def test_remat_gives_the_same_gradients(synth):
    batch, grads = None, []
    for remat in (False, True):
        model, proc = port_model(synth[3], remat=remat)
        batch = batch or ttrainer.to_device(VisualRetrieverCollator(proc)(examples(2, seed=30)), "cpu")
        loss, _, _ = ttrainer.compute_loss(model, batch, tlosses.ColbertLoss(), False)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        model.set_remat(not remat)
        assert model.model.visual.remat == model.model.language_model.remat == (not remat)
    assert grads[0].keys() == grads[1].keys() and any("visual" in n for n in grads[0])
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
