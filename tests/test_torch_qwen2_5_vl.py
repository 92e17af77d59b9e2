"""Port parity: ColQwen2_5 (Qwen2.5-VL) in colpali_tpu_torch against
colpali_tpu, on the CPU, on JAX's einsum route (no Pallas).

- The processor's window ids (and every other integer output) exactly.
- A windowed and a full-attention vision block apart, the tower, and
  ``ColQwen2_5`` on pages and on left-padded queries, fp32, the JAX
  parameters carried over by ``core/from_jax.py``: atol 2e-5 on the
  L2-normalized output, 1e-5 on the blocks' and the tower's features.
- ``load_retriever`` on ``make_synth_colqwen25`` against JAX's (the state
  dicts bit for bit), each package reading the other's export, and
  ``embed_dataset`` against JAX's (per-page embeddings at atol 2e-5: the
  repaired forwarding of the processor's whole batch).
- Stored int8 on a model whose patch embedding is 1,176 wide (K not a
  multiple of 16) and whose vision ``down_proj`` is 3,420 wide:
  ``quantize_params`` picks JAX's layers and gives its bytes bit for bit; a
  stored ``QDense`` at those widths (the plain Q1a/Q1b) equals JAX's bit for
  bit; the whole quantized forward on the plain route matches JAX's ``(qp,
  qc)`` forward by per-token cosine (mean >= 0.9999, min >= 0.999: an ulp
  of fp32 sum order can flip an int8 activation; the same model in fp32
  holds atol 2e-5).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.core.hf_export import export_colqwen25_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import load_colqwen25_params as jax_load_params  # noqa: E402
from colpali_tpu.evaluation.evaluator import embed_dataset as jax_embed_dataset  # noqa: E402
from colpali_tpu.models import qwen2_5_vl as jq  # noqa: E402
from colpali_tpu.models.qwen2_vl import Qwen2TextConfig as JaxTextConfig  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colqwen25_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colqwen25_params  # noqa: E402
from colpali_tpu_torch.evaluation.evaluator import embed_dataset  # noqa: E402
from colpali_tpu_torch.models import qwen2_5_vl as tq  # noqa: E402
from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig, vision_rope  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402

ATOL = 2e-5
# a stored-int8 model against JAX's: int8 flips where the fp32 sums' order moves an input by an ulp
# (measured on the 512-wide model below: mean 0.99995, min 0.99973)
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999
QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?", "a"]
PAGE_SHAPES = ((112, 84), (56, 112), (30, 40))  # 4 x 3, 2 x 4 and 2 x 3 merged units: windows of 2 x 2, edges cut


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import gate_families as gf

    path = tmp_path_factory.mktemp("synth") / "colqwen25-tiny"
    init = jq.ColQwen2_5.init
    jq.ColQwen2_5.init = lambda self, rng, **kw: jax.jit(lambda r, k: init(self, r, **k))(rng, kw)
    try:
        gf.make_synth_colqwen25(str(path))
    finally:
        jq.ColQwen2_5.init = init
    return str(path)


@pytest.fixture(scope="module")
def loaded(ckpt):
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    return jax_model, variables, jax_proc, model, proc


def _pages():
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
            for s, hw in enumerate(PAGE_SHAPES)]


def _torch(batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items() if k != "image_grid_thw"}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if k != "image_grid_thw"}


def test_processor_window_ids_match_jax(loaded):
    jax_proc, proc = loaded[2], loaded[4]
    assert proc.window_size == jax_proc.window_size == 56  # from the checkpoint's config.json
    got, want = proc.process_images(_pages(), device_pixels=True), jax_proc.process_images(_pages())
    assert set(got) == set(want)
    for key in ("input_ids", "attention_mask", "patch_mask", "vision_hpos", "vision_wpos", "position_ids",
                "image_grid_thw", "window_id"):
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    np.testing.assert_allclose(got["pixel_values"].numpy(), want["pixel_values"], atol=1e-4, rtol=0)
    window = got["window_id"]
    assert (window[~got["patch_mask"]] == -1).all() and window[0].max() == 3 and window[2].max() == 1


def _block_inputs(loaded, seed=0):
    jax_model, _, _, _, proc = loaded
    cfg = jax_model.config.vision
    batch = proc.process_images(_pages())
    x = np.random.default_rng(seed).normal(size=(*batch["patch_mask"].shape, cfg.hidden_size)).astype(np.float32)
    hpos, wpos = (torch.from_numpy(batch[k]) for k in ("vision_hpos", "vision_wpos"))
    rope = vision_rope(hpos, wpos, cfg.head_dim)
    seg_full = np.where(batch["patch_mask"], 1, -1).astype(np.int32)
    return cfg, batch, x, rope, seg_full, batch["window_id"]


@pytest.mark.parametrize("full", [False, True])
def test_windowed_and_full_blocks_match_jax(loaded, full):
    cfg, batch, x, rope, seg_full, seg_window = _block_inputs(loaded)
    index = cfg.fullatt_block_indexes[0] if full else 0
    params = loaded[1]["params"]["model"]["visual"][f"blocks_{index}"]
    want = np.asarray(jax.jit(jq.Qwen25VisionBlock(cfg).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(full), jnp.asarray(seg_full), jnp.asarray(seg_window),
        tuple(jnp.asarray(t.numpy()) for t in rope)))
    block = loaded[3].model.visual.blocks[index]
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(seg_full if full else seg_window), rope).numpy()
    valid = batch["patch_mask"]
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # the mask matters: the other flavour gives other values
        other = block(torch.from_numpy(x), torch.from_numpy(seg_window if full else seg_full), rope).numpy()
    assert np.abs(other[valid] - want[valid]).max() > 1e-3


@pytest.mark.parametrize("kind", ["tower", "pages", "queries"])
def test_colqwen2_5_matches_jax(loaded, kind):
    jax_model, variables, jax_proc, model, proc = loaded
    batch = proc.process_images(_pages()) if kind != "queries" else proc.process_queries(QUERIES)
    if kind == "tower":
        keys = ("pixel_values", "vision_hpos", "vision_wpos", "patch_mask", "window_id")
        want = np.asarray(jax.jit(jq.Qwen25VisionTower(jax_model.config.vision).apply)(
            {"params": variables["params"]["model"]["visual"]}, *(jnp.asarray(batch[k]) for k in keys)))
        with torch.no_grad():
            got = model.model.visual(*(torch.from_numpy(batch[k]) for k in keys)).numpy()
        valid = batch["patch_mask"].reshape(len(PAGE_SHAPES), -1, 4).all(-1)
        np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)
        return
    want = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
    with torch.no_grad():
        got = model(**_torch(batch)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_checkpoints_cross_load_bit_for_bit(loaded, tmp_path):
    jax_model, variables, _, model, _ = loaded
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    state = model.state_dict()
    assert set(state) == set(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    ours = export_colqwen25_state_dict(state)
    theirs = jax_export(jax.tree.map(np.asarray, variables["params"]))
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert np.array_equal(ours[key].numpy(), np.asarray(value)), key
    save_pretrained(str(tmp_path), state, config=model.config)
    back = state_dict_from_jax(jax.tree.map(np.asarray, jax_load_params(str(tmp_path))))
    assert all(torch.equal(back[k], v) for k, v in state.items())
    safetensors.save_file({k: np.asarray(v) for k, v in theirs.items()}, str(tmp_path / "model.safetensors"))
    again = load_colqwen25_params(str(tmp_path))
    assert all(torch.equal(again[k], v) for k, v in state.items())


def test_embed_dataset_matches_jax(loaded):
    jax_model, variables, jax_proc, model, proc = loaded
    pages = _pages()
    want = jax_embed_dataset(jax.jit(jax_model.apply), variables, jax_proc, pages, batch_size=2)
    got = embed_dataset(model, proc, pages, batch_size=2)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    queries = embed_dataset(model, proc, QUERIES, is_images=False, use_query_prompt=True)
    want_q = jax_embed_dataset(jax.jit(jax_model.apply), variables, jax_proc, QUERIES, is_images=False,
                               use_query_prompt=True)
    for g, w in zip(queries, want_q):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


# -- stored int8 at K = 1,176 and 3,420 --------------------------------------------

WIDE_VISION = dict(depth=2, hidden_size=512, num_heads=4, intermediate_size=3420, out_hidden_size=48,
                   window_size=56, fullatt_block_indexes=(1,))
WIDE_TEXT = dict(vocab_size=128, hidden_size=48, intermediate_size=96, num_hidden_layers=1, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=12, mrope_section=(2, 2, 2))


@pytest.fixture(scope="module")
def wide(loaded):
    """JAX params of a ColQwen2.5 with a 512-wide vision tower and the
    processor's batch for it."""
    proc = loaded[4]
    cfg = jq.Qwen25VLConfig(vision=jq.Qwen25VLVisionConfig(**WIDE_VISION), text=JaxTextConfig(**WIDE_TEXT),
                            image_token_id=5, vision_start_token_id=3)
    jax_model = jq.ColQwen2_5(cfg, dim=128)
    batch = proc.process_images(_pages()[:2])
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), **_jax(batch))["params"]
    port_cfg = tq.Qwen25VLConfig(vision=tq.Qwen25VLVisionConfig(**WIDE_VISION), text=Qwen2TextConfig(**WIDE_TEXT),
                                 image_token_id=5, vision_start_token_id=3)
    return jax_model, jax.tree.map(np.asarray, params), port_cfg, batch


def test_quantize_params_gives_jax_layers_and_bytes_at_k_1176_and_3420(wide):
    jax_model, params, port_cfg, batch = wide
    qp, qc = jqd.quantize_params(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    model = tq.ColQwen2_5(port_cfg, dim=128, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(model)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths)
    assert "model/visual/patch_embed/kernel" in paths and "model/visual/blocks_0/mlp/down_proj/kernel" in paths
    assert "model/visual/merger_fc2/kernel" not in paths  # 2,048 -> 48: exact by shape
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    vis = model.model.visual
    assert vis.patch_embed.weight.shape == (512, 1176) and vis.patch_embed.weight.stride(0) == 1184  # rows on 16 B
    assert vis.blocks[0].mlp.down_proj.weight.stride(0) == 3424

    # the forward: fp32 products exactly as JAX's up to the order of sums, so a stored
    # layer's input can differ by an ulp and flip an int8 value (quantized activations are
    # discontinuous): the fp32 model at ATOL, the stored-int8 one by per-token cosine
    float_model = tq.ColQwen2_5(port_cfg, dim=128, device="cpu").eval()
    float_model.load_state_dict(state_dict_from_jax(params))
    mask = np.asarray(batch["attention_mask"]).astype(bool)
    for m, variables in ((float_model, {"params": params}), (model, {"params": qp, "quant": qc})):
        want_out = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
        with torch.no_grad():
            got_out = m(**_torch(batch)).numpy()
        if m is float_model:
            np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=0)
            continue
        a, b = got_out[mask], want_out[mask]
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.mean() >= QUANT_COS_MEAN and cos.min() >= QUANT_COS_MIN, (cos.mean(), cos.min())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(1176, 1280), (3420, 512), (512, 3420)])
@torch.no_grad()
def test_stored_qdense_at_k_not_a_multiple_of_16_bit_exact_against_jax(k, n, dtype):
    """A stored-int8 ``QDense`` (Q1a then Q1b, their plain versions on the
    CPU: the card kernels' oracle) at the Qwen widths against JAX's QDense
    applying ``quantize_params``' ``(qp, qc)``, bit for bit, with a bias."""
    from colpali_tpu.models.layers import QDense as JaxQDense
    from colpali_tpu_torch.models.layers import QDense

    rng = np.random.default_rng(k + n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = (rng.normal(size=(2, 19, k)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.5).astype(np.float32)
    qp, qc = jqd.quantize_params({"kernel": jnp.asarray(w, jdt), "bias": jnp.asarray(b, jdt)})
    want = jax.jit(JaxQDense(n, dtype=jdt, param_dtype=jdt).apply)({"params": qp, "quant": qc}, jnp.asarray(x, jdt))
    layer = QDense(k, n, device="cpu", dtype=tdt)
    layer.weight.copy_(torch.from_numpy(w.T.copy()).to(tdt))
    layer.bias.copy_(torch.from_numpy(b).to(tdt))
    assert qd.quantize_params(layer) == ["/kernel"] and layer.stored
    assert layer.weight.stride(0) == qd.row_stride(k)
    got = layer(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
