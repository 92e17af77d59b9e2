"""Port parity: LoRA training of ColQwen2 in colpali_tpu_torch against
colpali_tpu, on the CPU, fp32, on a tiny checkpoint (vision 2 x 64, text
2 x 48, GQA 4/2) that the port writes and each package's
``load_retriever`` reads. The oracle is
JAX's step composed from its own pieces (``tests/qwen_lora_oracle.py``).

- ``VisualRetrieverCollator`` on the processor's batches with image
  negatives against JAX's, with and without padding targets: integers
  exactly, pixels at 1e-4.
- The adapted kernels under ``DEFAULT_TARGET_PATTERN`` are the paths JAX's
  ``init_lora_params`` picks.
- Two LoRA steps at the recipe's loss (``ColbertLoss(temperature=0.02)``)
  against JAX's step: loss rtol 1e-4, grad norm rtol 1e-3, as
  ``tests/test_torch_trainer.py`` holds ColPali; each step's adapter
  gradients before the optimizer at 1e-3 of each leaf's RMS; the adapters
  at atol 1e-5, but those whose JAX gradient lies below that noise, held
  to Adam's step bound (``GRAD_RTOL_RMS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu import losses as jlosses  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator  # noqa: E402
from colpali_tpu.training import lora as jlora  # noqa: E402
from colpali_tpu_torch import losses as tlosses  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.core.from_jax import lora_from_jax  # noqa: E402
from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: E402
from colpali_tpu_torch.training import trainer as ttrainer  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
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
    examples,
    start_adapters,
    write_checkpoint,
)

SPEC = LoraSpec(rank=RANK, alpha=ALPHA, dropout=0.0)
# the port's adapter gradients before the optimizer against JAX's: fp32 sums in another order, at most 3.6e-5 of
# the leaf's RMS over 7 runs on the CPU. An adapter element whose JAX gradient lies below that noise (held here at
# 1e-3 of the RMS) can take another Adam step on each side (its update is g / (|g| + eps) times the rate, and where
# |g| is a few eps, or the two gradients differ in sign, a 1e-9 gap moves it by 4.5e-5): such elements are held to
# Adam's step bound, each side moving at most the rate a step, so 2 x the summed rate apart; every other element at
# ADAPTER_ATOL as before
GRAD_RTOL_RMS = 1e-3


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """(JAX model, variables, JAX processor, checkpoint dir), fp32."""
    path = str(tmp_path_factory.mktemp("synth") / "colqwen2")
    write_checkpoint(path, "colqwen2")
    return (*jax_load_retriever(path, dtype=jnp.float32, param_dtype=jnp.float32), path)


def port_model(path):
    model, proc = load_retriever(path, family="colqwen2", dtype=torch.float32, device="cpu")
    return model.train(), proc


@pytest.mark.parametrize("padded", [False, True])
def test_collator_batches_match_jax(synth, padded):
    jproc, path = synth[2], synth[3]
    pad = dict(pad_seq_to=[96, 160], pad_patches_to=[192, 256]) if padded else {}
    batch = examples(2, negatives=2)
    got = VisualRetrieverCollator(port_model(path)[1], **pad)(batch)
    assert_collated_like_jax(got, JaxCollator(jproc, device_pixels=False, **pad)(batch), padded)
    assert "doc_window_id" not in got and got["neg_doc_pixel_values"].shape[:2] == (2, 2)


def test_adapter_paths_match_init_lora_params(synth):
    variables, path = synth[1], synth[3]
    model = port_model(path)[0]
    want = jlora.init_lora_params(variables["params"], jax.random.PRNGKey(1), rank=RANK)
    paths = LoraAdapters(model, SPEC).paths
    assert sorted(paths) == sorted(want) and len(paths) == 7 * model.config.text.num_hidden_layers + 1


def test_two_lora_steps_match_jax(synth):
    jmodel, variables, _, path = synth
    model, proc = port_model(path)
    start = start_adapters(variables["params"])
    batch = VisualRetrieverCollator(proc)(examples(3, seed=40))
    oracle = JaxOracle(jmodel, variables["params"], start, jlosses.ColbertLoss(temperature=0.02), False)
    adapters = LoraAdapters(model, SPEC)
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
        for path, ab in grads[-1].items():  # the gradients before clipping and Adam, per leaf
            for name, g in ab.items():
                w = oracle.grads[path][name]
                noise = GRAD_RTOL_RMS * np.sqrt(np.mean(np.square(w)))
                assert np.abs(g - w).max() <= noise, f"{path}/{name}"
                near_eps[path][name] |= np.abs(w) < noise
    lr_sum = sum(ttrainer.learning_rate_at(state.config, count) for count in range(state.step))
    assert_adapters(adapters, oracle.lora, start, near_eps, step_bound=2 * lr_sum)
