"""Port parity: ColQwen3 / BiQwen3 (Qwen3-VL) in colpali_tpu_torch against
colpali_tpu, on the CPU, fp32, JAX's attention on its einsum route (no
Pallas), at the tiny widths of ``scripts/gate_families.py``'s
``make_synth_colqwen3`` (vision 2 x 32, 4 heads, a 4 x 4 position table,
deepstack after blocks 0 and 1; text 2 x 48, GQA 4/2 x 12, M-RoPE (2, 2, 2)).

- Exactly: ``pos_embed_interp_indices`` (integers and float32 weights) at
  the tiny and the published grid sides; the processor's integers and taps,
  also on its ``device_pixels`` path; pixels at 1e-4.
- Interleaved M-RoPE at 1e-6, at the tiny section and at Qwen3-VL-4B's
  (24, 20, 20) with head 128, where Qwen2's chunked sections give other
  tables.
- At atol 2e-5, the JAX parameters (the checkpoint's, every leaf moved by
  seeded noise so that norms and biases are not at their initial values)
  carried over by ``core/from_jax.py``: the vision tower with its deepstack
  taps (also under ``remat``, gradients on); the decoder with the taps
  injected over a left-padded batch of unequal pages; ColQwen3 on pages and
  queries; BiQwen3.
- Checkpoints: JAX's ``make_synth_colqwen3`` read by the port bit for bit,
  the port's export read by JAX's loader bit for bit, both exports equal.
- Stored int8: ``quantize_params`` gives JAX's layers and bytes bit for bit;
  the quantized forward by per-token cosine (an ulp of fp32 sum order can
  flip an int8 activation); Qwen3-VL-4B's parameter tree by shapes alone
  (``jax.eval_shape``, never compiled) against the port's on ``meta``.
- K3's plain version at D=320 (ColQwen3's head) against
  ``maxsim_pallas_int8mxu_tiled(interpret=True)`` at rtol 1e-5.
"""

import dataclasses
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.auto import detect_family as jax_detect_family  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.core.hf_export import export_colqwen3_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import load_colqwen3_params as jax_load_params  # noqa: E402
from colpali_tpu.models import qwen3_vl as jq  # noqa: E402
from colpali_tpu.models.layers import make_attention_bias  # noqa: E402
from colpali_tpu.ops import maxsim_pallas as jp  # noqa: E402
from colpali_tpu.ops import quant as jquant  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu_torch.auto import _NOT_PORTED, _PORTED, detect_family, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colqwen3_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colqwen3_params  # noqa: E402
from colpali_tpu_torch.models import qwen3_vl as tq  # noqa: E402
from colpali_tpu_torch.models.qwen2_vl import mrope_cos_sin  # noqa: E402
from colpali_tpu_torch.ops import maxsim_tiled as tt  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.processors.bi import BiQwen3Processor  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402

ATOL = 2e-5
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999  # test_torch_qwen2_5_vl.py's rule for a stored-int8 forward
QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?", "a"]
PAGE_SHAPES = ((112, 84), (56, 112), (30, 40))  # 4 x 3, 2 x 4 and 2 x 3 merged units: unequal pages
VISION_KEYS = ("pixel_values", "vision_hpos", "vision_wpos", "patch_mask", "pos_idx", "pos_weight")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import gate_families as gf

    path = tmp_path_factory.mktemp("synth") / "colqwen3-tiny"
    init = jq.ColQwen3.init
    jq.ColQwen3.init = lambda self, rng, **kw: jax.jit(lambda r, k: init(self, r, **k))(rng, kw)
    try:
        gf.make_synth_colqwen3(str(path))
    finally:
        jq.ColQwen3.init = init
    return str(path)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(JAX model, its variables with every leaf moved by seeded noise, JAX
    processor, the port's ColQwen3 holding the same weights, its processor)."""
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(size=x.shape) * 0.05).astype(np.float32),
                          variables["params"])
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, {"params": params}, jax_proc, model.eval(), proc


def _pages():
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
            for s, hw in enumerate(PAGE_SHAPES)]


def _torch(batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items() if k != "image_grid_thw"}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if k != "image_grid_thw"}


@pytest.mark.parametrize("grid,side", [((1, 4, 6), 4), ((1, 2, 2), 4), ((2, 8, 10), 48), ((1, 64, 48), 48),
                                       ((1, 50, 66), 48)])
def test_pos_embed_interp_indices_match_jax_exactly(grid, side):
    got, want = tq.pos_embed_interp_indices(grid, side, 2), jq.pos_embed_interp_indices(grid, side, 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (np.prod(grid), 4) and np.array_equal(g, w)
    assert np.allclose(got[1].sum(-1), 1.0, atol=1e-6) and got[0].max() < side * side


def test_processor_integers_and_taps_match_jax(loaded):
    jax_proc, proc = loaded[2], loaded[4]
    assert proc.num_grid_per_side == jax_proc.num_grid_per_side == 4  # from the checkpoint's config.json
    assert (proc.patch_size, proc.merge_size, proc.max_pixels) == (jax_proc.patch_size, 2, jax_proc.max_pixels)
    want = jax_proc.process_images(_pages())
    for got in (proc.process_images(_pages()), proc.process_images(_pages(), device_pixels=True)):
        assert set(got) == set(want)
        for key in ("input_ids", "attention_mask", "patch_mask", "vision_hpos", "vision_wpos", "position_ids",
                    "image_grid_thw", "pos_idx", "pos_weight"):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype and np.array_equal(g, w), key
        np.testing.assert_allclose(np.asarray(got["pixel_values"]), want["pixel_values"], atol=1e-4, rtol=0)
    pad = ~got["patch_mask"]
    assert pad.any() and not got["pos_idx"][pad].any() and not got["pos_weight"][pad].any()
    assert (got["attention_mask"] == 0).any()  # unequal pages: left padding


@pytest.mark.parametrize("head_dim,section", [(12, (2, 2, 2)), (128, (24, 20, 20))])
def test_interleaved_mrope_matches_jax(head_dim, section):
    # positions up to 1,024 (a page's stay under ~100: its image advances them by the grid's longer side, 48 at
    # 768 merged tokens); the two packages' pow round an inv_freq an ulp apart, which moves a phase by about
    # position x 1e-9 (9.5e-7 at 1,024)
    pos = np.random.default_rng(head_dim).integers(0, 1024, size=(3, 2, 17)).astype(np.int64)
    want = jq.interleaved_mrope_cos_sin(jnp.asarray(pos), head_dim, 5e6, section)
    got = tq.interleaved_mrope_cos_sin(torch.from_numpy(pos), head_dim, 5e6, section)
    for g, w in zip(got, want):
        assert g.shape == (2, 17, head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    if head_dim == 128:  # a selection of channels: Qwen2's chunked sections give other tables
        chunked = mrope_cos_sin(torch.from_numpy(pos), head_dim, 5e6, section)
        assert (chunked[0] - got[0]).abs().max() > 0.5


def test_vision_tower_and_deepstack_taps_match_jax(loaded):
    jax_model, variables, _, model, proc = loaded
    batch = proc.process_images(_pages())
    tower = jq.Qwen3VisionTower(jax_model.config.vision)
    merged, taps = jax.jit(tower.apply)({"params": variables["params"]["model"]["visual"]},
                                        *(jnp.asarray(batch[k]) for k in VISION_KEYS))
    valid = batch["patch_mask"].reshape(len(PAGE_SHAPES), -1, 4).all(-1)
    feed = [torch.from_numpy(batch[k]) for k in VISION_KEYS]
    visual = model.model.visual
    with torch.no_grad():
        got_merged, got_taps = visual(*feed)
    assert len(got_taps) == len(taps) == 2
    for g, w in zip((got_merged, *got_taps), (merged, *taps)):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid], atol=1e-5, rtol=0)
    visual.remat = True  # checkpointed blocks, gradients on: the taps still come out, the same
    try:
        rem_merged, rem_taps = visual(*feed)
    finally:
        visual.remat = False
    assert rem_merged.requires_grad and len(rem_taps) == 2
    for g, w in zip((rem_merged, *rem_taps), (got_merged, *got_taps)):
        assert torch.equal(g.detach(), w)


def test_decoder_with_deepstack_injection_matches_jax_on_left_padded_pages(loaded):
    jax_model, variables, _, model, proc = loaded
    cfg = jax_model.config
    batch = proc.process_images(_pages())
    ids, mask, pos = (np.asarray(batch[k]) for k in ("input_ids", "attention_mask", "position_ids"))
    image = ids == cfg.image_token_id
    assert (mask == 0).any() and len(set(image.sum(1).tolist())) == 3  # left-padded, unequal image spans
    rng = np.random.default_rng(7)
    embeds = rng.normal(size=(*ids.shape, cfg.text.hidden_size)).astype(np.float32)
    n_img = batch["patch_mask"].shape[1] // 4
    deepstack = [rng.normal(size=(ids.shape[0], n_img, cfg.text.hidden_size)).astype(np.float32) for _ in range(2)]
    want = np.asarray(jax.jit(jq.Qwen3Decoder(cfg.text).apply)(
        {"params": variables["params"]["model"]["language_model"]}, jnp.asarray(embeds),
        make_attention_bias(jnp.asarray(mask), causal=True), jnp.asarray(pos), jnp.asarray(image),
        [jnp.asarray(d) for d in deepstack]))
    decoder = model.model.language_model
    args = (torch.from_numpy(embeds), torch.from_numpy(mask), torch.from_numpy(pos), torch.from_numpy(image))
    with torch.no_grad():
        got = decoder(*args, [torch.from_numpy(d) for d in deepstack]).numpy()
        without = decoder(*args).numpy()
    rows = mask.astype(bool)
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=0)
    assert np.abs(without[rows] - want[rows]).max() > 1e-2  # the injection matters


@pytest.mark.parametrize("kind", ["pages", "queries", "bi"])
def test_colqwen3_and_biqwen3_match_jax(loaded, kind):
    jax_model, variables, jax_proc, model, proc = loaded
    batch = proc.process_queries(QUERIES) if kind == "queries" else proc.process_images(_pages())
    if kind == "bi":
        jbi = jq.BiQwen3(jax_model.config)
        bparams = {"params": {"model": variables["params"]["model"]}}
        bi_model = tq.BiQwen3(model.config, device="cpu").eval()
        bi_model.load_state_dict({k: v for k, v in model.state_dict().items() if k.startswith("model.")})
        bproc = BiQwen3Processor(proc.tokenizer, patch_size=proc.patch_size, num_grid_per_side=4,
                                 min_pixels=proc.min_pixels, max_pixels=proc.max_pixels, image_mean=proc.image_mean,
                                 image_std=proc.image_std, device="cpu")
        batch = bproc.process_images(_pages())
        want = np.asarray(jax.jit(jbi.apply)(bparams, **_jax(batch)))
        with torch.no_grad():
            got = bi_model(**_torch(batch)).numpy()
        assert got.shape == (len(PAGE_SHAPES), model.config.text.hidden_size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        scores = bproc.score(list(torch.from_numpy(got)), list(torch.from_numpy(got)))
        assert np.argmax(np.asarray(scores), axis=1).tolist() == [0, 1, 2]
        return
    want = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
    with torch.no_grad():
        got = model(**_torch(batch)).numpy()
    assert got.shape == want.shape and got.shape[-1] == 320 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_checkpoints_cross_load_bit_for_bit(ckpt, tmp_path):
    _, variables, _ = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, _ = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    state = model.state_dict()
    assert set(state) == set(want) and "model.visual.deepstack_merger_1.norm.weight" in state
    assert state["model.visual.deepstack_merger_0.norm.weight"].shape == (4 * 32,)  # the post-shuffle LayerNorm
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    ours = export_colqwen3_state_dict(state, patch_size=14)
    theirs = jax_export(jax.tree.map(np.asarray, variables["params"]), patch_size=14)
    assert set(ours) == set(theirs) and "model.visual.deepstack_merger_list.0.linear_fc1.weight" in ours
    for key, value in theirs.items():
        assert np.array_equal(ours[key].numpy(), np.asarray(value)), key
    save_pretrained(str(tmp_path), state, config=model.config)  # the training export: exporter by the config
    back = state_dict_from_jax(jax.tree.map(np.asarray, jax_load_params(str(tmp_path))))
    assert set(back) == set(state) and all(torch.equal(back[k], v) for k, v in state.items())
    assert tq.Qwen3VLConfig.from_hf_config(json.loads((tmp_path / "config.json").read_text())) == model.config
    safetensors.save_file({k: np.asarray(v) for k, v in theirs.items()}, str(tmp_path / "model.safetensors"))
    again = load_colqwen3_params(str(tmp_path))
    assert all(torch.equal(again[k], v) for k, v in state.items())


def test_load_retriever_registry_row_matches_jax(ckpt):
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    assert type(model) is tq.ColQwen3 and model.head.custom_text_proj.out_features == 320
    assert proc.max_pixels == 768 * 28 * 28  # max_num_visual_tokens 768 at this checkpoint's 14 px patches
    assert "colqwen3" in _PORTED and set(_NOT_PORTED) == {"colqwen_omni"}
    for cfg in ({"model_type": "qwen3_vl"}, {"model_type": "qwen3_vl_moe"}, {"architectures": ["ColQwen3"]}):
        assert detect_family(cfg) == jax_detect_family(cfg) == "colqwen3"


def test_quantize_params_matches_jax_and_the_full_width_tree(loaded):
    jax_model, variables, _, model, proc = loaded
    params = variables["params"]
    qp, qc = jqd.quantize_params(params, min_dim=32)
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    qmodel = tq.ColQwen3(model.config, device="cpu").eval()
    qmodel.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(qmodel, min_dim=32)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths) and "model/visual/deepstack_merger_1/linear_fc1/kernel" in paths
    got = qmodel.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    batch = proc.process_images(_pages())
    mask = np.asarray(batch["attention_mask"]).astype(bool)
    want_out = np.asarray(jax.jit(jax_model.apply)({"params": qp, "quant": qc}, **_jax(batch)))
    with torch.no_grad():
        got_out = qmodel(**_torch(batch)).numpy()
    a, b = got_out[mask], want_out[mask]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.mean() >= QUANT_COS_MEAN and cos.min() >= QUANT_COS_MIN, (cos.mean(), cos.min())

    # Qwen3-VL-4B by shapes alone: JAX's tree under eval_shape, the port's model on "meta"
    full = jq.Qwen3VLConfig()
    p, s = 16, 12
    shapes = jax.eval_shape(jq.ColQwen3(full).init, jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
                            jnp.ones((1, s), jnp.int32), jnp.zeros((1, p, full.vision.patch_dim), jnp.float32),
                            vision_hpos=jnp.zeros((1, p), jnp.int32), vision_wpos=jnp.zeros((1, p), jnp.int32),
                            patch_mask=jnp.ones((1, p), bool), pos_idx=jnp.zeros((1, p, 4), jnp.int32),
                            pos_weight=jnp.zeros((1, p, 4), jnp.float32))["params"]
    flat = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    meta = tq.ColQwen3(tq.Qwen3VLConfig(), device="meta", dtype=torch.bfloat16)
    port_shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    want_shapes = {_port_name(path): tuple(reversed(shape)) if path.endswith("/kernel") else tuple(shape)
                   for path, shape in flat.items()}
    assert want_shapes == port_shapes
    n_params = sum(int(np.prod(s)) for s in flat.values())
    assert n_params == sum(v.numel() for v in meta.parameters()) and 4.4e9 < n_params < 4.7e9
    full_qc = jax.eval_shape(lambda x: jqd.quantize_params(x)[1], shapes)
    full_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                  for path, _ in jax.tree_util.tree_flatten_with_path(full_qc)[0]]
    assert sorted(qd.quantize_params(meta)) == sorted(full_paths)
    assert dataclasses.asdict(tq.Qwen3VLConfig()) == dataclasses.asdict(full)


def _port_name(path: str) -> str:
    """A JAX parameter path's name in the port (``core/from_jax.py``'s rule)."""
    *parts, last = path.split("/")
    last = "weight" if last in ("kernel", "embedding", "scale") else last
    return ".".join(re.sub(r"^(layers|blocks)_(\d+)$", r"\1.\2", p) for p in (*parts, last))


@pytest.mark.parametrize("b,nq", [(1, 8), (2, 5)])
def test_k3_plain_at_d320_matches_pallas_interpret(b, nq):
    rng = np.random.default_rng(b + nq)
    docs = rng.normal(size=(2 * 128, 6, 320)).astype(np.float32)
    docs[:, -2:] = 0.0  # zero-padded doc tokens: value 0, scale 1
    store, scales = (np.asarray(x) for x in jquant.quantize_per_token(jnp.asarray(
        docs.reshape(2, 128, 6, 320).transpose(0, 2, 1, 3))))
    q = rng.normal(size=(b, nq, 320)).astype(np.float32)
    q[:, -1] = 0.0
    qi, qs = jquant.quantize_per_token(jnp.asarray(q))
    want = np.asarray(jp.maxsim_pallas_int8mxu_tiled(qi, qs, jnp.asarray(store), jnp.asarray(scales),
                                                     interpret=True))
    got = tt.maxsim_int8mxu_tiled(torch.from_numpy(np.array(qi)), torch.from_numpy(np.array(qs)),
                                  torch.from_numpy(store), torch.from_numpy(scales))
    assert got.shape == (b, 2 * 128) and 320 in tt.INT8_DIMS
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
