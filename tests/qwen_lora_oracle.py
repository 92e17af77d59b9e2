"""Shared pieces of the Qwen2-VL family's training parity tests
(``test_torch_qwen*_training.py``): synthetic data, and JAX's LoRA step
composed from the JAX package's own pieces.

The JAX trainer's ``_forward`` calls ``apply_fn(variables, ids, mask,
pixels)`` and nothing more, so a Qwen page batch reaches the vision tower
without its geometry. The oracle here calls ``model.apply`` by keyword with
every input the sub-batch holds (as ``perf/train_bench.py`` does) inside
``training.lora.make_lora_train_step``, takes ``jax.value_and_grad`` of it
in one ``jit`` and updates with ``training.trainer.create_optimizer``: clip
by global norm, AdamW and the warm-up/decay schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from colpali_tpu.training import lora as jlora
from colpali_tpu.training import trainer as jtrainer
from colpali_tpu_torch.training.trainer import MODEL_INPUTS

LOSS_RTOL, NORM_RTOL, ADAPTER_ATOL = 1e-4, 1e-3, 1e-5  # tests/test_torch_trainer.py's for ColPali
QUERIES = ["what is the total revenue ?", "find the quarterly report", "describe the chart data",
           "price of the chip"]
PAGE_SHAPES = ((112, 84), (56, 112), (70, 50), (84, 84), (30, 40), (56, 56))
RANK, ALPHA = 4, 8.0
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.01, max_grad_norm=0.05)


def write_checkpoint(path, family, seed=0):
    """A tiny ColQwen2 or ColQwen2.5 (vision 2 x 64, one windowed and one
    full block for 2.5; text 2 x 48, GQA 4/2 x 12) with seeded random
    weights, every bias and norm included, written by the port as an HF
    checkpoint with a word-level tokenizer at Qwen2's special ids, which
    both packages' ``load_retriever`` read (bit for bit, as the Qwen parity tests hold)."""
    from colpali_tpu_torch.models.qwen2_5_vl import ColQwen2_5, Qwen25VLConfig, Qwen25VLVisionConfig
    from colpali_tpu_torch.models.qwen2_vl import ColQwen2, Qwen2TextConfig, Qwen2VLConfig, Qwen2VLVisionConfig
    from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
    from colpali_tpu_torch.utils.testing import qwen_word_tokenizer, write_qwen_checkpoint

    text = Qwen2TextConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, head_dim=12, mrope_section=(2, 2, 2))
    if family == "colqwen2_5":
        vision = Qwen25VLVisionConfig(depth=2, hidden_size=64, num_heads=4, intermediate_size=128, out_hidden_size=48,
                                      window_size=56, fullatt_block_indexes=(1,))
        model = ColQwen2_5(Qwen25VLConfig(vision=vision, text=text), device="cpu")
    else:
        vision = Qwen2VLVisionConfig(depth=2, embed_dim=64, num_heads=4, mlp_ratio=2.0, hidden_size=48)
        model = ColQwen2(Qwen2VLConfig(vision=vision, text=text), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    words = ColQwen2Processor.visual_prompt_prefix.replace("\n", " ").split() + " ".join(QUERIES).split()
    write_qwen_checkpoint(path, model, qwen_word_tokenizer([w for w in words if "<|" not in w]),
                          max_num_visual_tokens=64)


def pages(n, seed=0):
    return [np.random.default_rng(seed + i).integers(0, 256, size=(*PAGE_SHAPES[i % len(PAGE_SHAPES)], 3),
                                                     dtype=np.uint8) for i in range(n)]


def examples(n, negatives=0, seed=0):
    """``n`` examples (query, page, and ``negatives`` pages of negatives each)."""
    imgs = pages(n * (1 + negatives), seed)
    return [{"query": QUERIES[i % len(QUERIES)], "pos_target": imgs[i],
             **({"neg_target": imgs[n + negatives * i: n + negatives * (i + 1)]} if negatives else {})}
            for i in range(n)]


def jax_embed(jmodel, variables, batch, prefix):
    """``model.apply`` by keyword with every input the sub-batch holds;
    negatives flattened on their batch axis (axis 1 of ``position_ids``)."""
    ids, mask = batch[f"{prefix}input_ids"], batch[f"{prefix}attention_mask"]
    kw = {n: batch[f"{prefix}{n}"] for n in MODEL_INPUTS if f"{prefix}{n}" in batch}
    if ids.ndim == 2:
        return jmodel.apply(variables, ids, mask, **kw)
    b, n, s = ids.shape
    kw = {k: v.reshape(3, b * n, -1) if k == "position_ids" else v.reshape(b * n, *v.shape[2:]) for k, v in kw.items()}
    emb = jmodel.apply(variables, ids.reshape(b * n, s), mask.reshape(b * n, s), **kw)
    return emb.reshape(b, n, *emb.shape[1:])


def start_adapters(params):
    """JAX's ``init_lora_params`` with ``b`` moved off zero, so that ``a`` takes a gradient too."""
    rng = np.random.default_rng(1)
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=RANK))
    return {p: {"a": ab["a"], "b": rng.normal(size=ab["b"].shape).astype(np.float32) * 0.05} for p, ab in lora.items()}


class JaxOracle:
    """JAX's LoRA training over ``base`` (with the ``quant`` collection of a
    stored-int8 tower, if given), from the adapters ``lora``."""

    def __init__(self, jmodel, base, lora, loss_fn, negatives, quant=None):
        extra = {"quant": quant} if quant is not None else {}

        def loss_forward(params, batch):
            variables = {"params": params, **extra}
            return loss_fn(*(jax_embed(jmodel, variables, batch, p) for p in ("query_", "doc_", "neg_doc_")[:2 + negatives]))

        self.grad = jax.jit(jax.value_and_grad(jlora.make_lora_train_step(loss_forward, ALPHA, RANK)))
        self.tx = jtrainer.create_optimizer(jtrainer.TrainConfig(**TRAIN))
        self.base, self.lora = base, jax.tree.map(jnp.asarray, lora)
        self.opt_state = self.tx.init(self.lora)

    def step(self, batch):
        """One update on a collated batch -> ``(loss, grad_norm)``; the
        step's gradients before the optimizer stay in ``self.grads``."""
        feed = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if not k.endswith("image_grid_thw")}
        loss, grads = self.grad(self.lora, self.base, feed)
        self.grads = jax.tree.map(np.asarray, grads)
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.lora)
        self.lora = optax.apply_updates(self.lora, updates)
        return float(loss), float(optax.global_norm(grads))


def assert_adapters(adapters, jax_lora, start, near_eps=None, step_bound=0.0):
    """The port's adapters at ``ADAPTER_ATOL`` of JAX's, each moved from
    ``start``; the elements that ``near_eps`` (``{path: {"a", "b": bool
    masks}}``) marks are held at ``step_bound`` instead."""
    for path, ab in adapters.tree().items():
        for name in ("a", "b"):
            got, want = ab[name].numpy(), np.asarray(jax_lora[path][name])
            loose = near_eps[path][name] if near_eps is not None else np.zeros(got.shape, bool)
            np.testing.assert_allclose(got[~loose], want[~loose], atol=ADAPTER_ATOL, err_msg=f"{path}/{name}")
            assert np.abs(got[loose] - want[loose]).max(initial=0.0) <= step_bound, f"{path}/{name}"
            assert not np.array_equal(got, start[path][name])


def recording_gradients(state):
    """Make ``state.apply_gradients`` first append the adapters' gradients
    (``{path: {"a", "b"}}``, before clipping and the optimizer) to the
    returned list."""
    seen, apply, adapters = [], state.apply_gradients, state.adapters

    def apply_recording():
        seen.append({p: {"a": adapters.a[i].grad.numpy().copy(), "b": adapters.b[i].grad.numpy().copy()}
                     for i, p in enumerate(adapters.paths)})
        return apply()

    state.apply_gradients = apply_recording
    return seen


def assert_collated_like_jax(got, want, padded):
    """The port's collated batch against JAX's: integers exactly, pixels at
    1e-4 (test_torch_processor_surface.py's rule for the two resizes); with
    padding targets ``window_id`` holds JAX's ids, then -1 to the padded
    patch length, and Qwen3-VL's ``pos_idx``/``pos_weight (..., P, 4)``
    JAX's taps, then zeros (JAX leaves all three unpadded)."""
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        if key.endswith("pixel_values"):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=key)
        elif key.endswith("window_id") and padded:
            assert g.shape[-1] == np.asarray(got[key.replace("window_id", "patch_mask")]).shape[-1] > w.shape[-1]
            assert np.array_equal(g[..., : w.shape[-1]], w) and (g[..., w.shape[-1]:] == -1).all(), key
        elif key.endswith(("pos_idx", "pos_weight")) and padded:
            n = w.shape[-2]
            assert g.shape[-2] == np.asarray(got[key[: key.index("pos_")] + "patch_mask"]).shape[-1] > n
            assert g.dtype == w.dtype and np.array_equal(g[..., :n, :], w) and not g[..., n:, :].any(), key
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), key
