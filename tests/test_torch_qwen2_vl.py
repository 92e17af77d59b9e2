"""Port parity: ColQwen2 (Qwen2-VL) in colpali_tpu_torch against colpali_tpu,
on the CPU, on JAX's einsum route (no Pallas).

- The processor (``make_synth_colqwen2``'s tokenizer and preprocessor
  config): its integer outputs exactly; the pixels within 1e-5 of
  ``jax.image.resize``'s weights contracted in fp64 and within 1e-4 of
  JAX's own pixels, which sit up to 2.2e-5 from that oracle here (the rule
  of test_torch_processor_surface.py).
- The rotary tables, the vision tower, the decoder and ``ColQwen2`` on
  pages and on left-padded queries, fp32, the JAX parameters carried over
  by ``core/from_jax.py``: atol 2e-5 on the L2-normalized output (1e-5 on
  the tables and the tower's features, which are not normalized but of
  order 1), the same arithmetic summed in another order.
- Checkpoints: ``load_retriever`` on ``make_synth_colqwen2`` against JAX's
  (the state dicts bit for bit), each package reading the other's export,
  ``save_pretrained`` from a ``Qwen2VLConfig``.
- ``QueryEncoder._pad_static`` on ``(3, B, T)`` M-RoPE positions at B = 1,
  3 and 5 against JAX's.
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
from colpali_tpu.core.hf_export import export_colqwen2_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import load_colqwen2_params as jax_load_params  # noqa: E402
from colpali_tpu.models import qwen2_vl as jq  # noqa: E402
from colpali_tpu.retrieval.serving import QueryEncoder as JaxQueryEncoder  # noqa: E402
from colpali_tpu_torch.auto import detect_family, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colqwen2_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colqwen2_params  # noqa: E402
from colpali_tpu_torch.models import qwen2_vl as tq  # noqa: E402
from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor  # noqa: E402
from colpali_tpu_torch.retrieval.serving import QueryEncoder  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402

ATOL = 2e-5
QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?", "a"]
PAGE_SHAPES = ((70, 50), (56, 112), (30, 40))  # three smart_resize targets, one of them upscaled


def _jit_init(cls):
    """``cls.init`` compiled (the same init, seconds faster on the CPU)."""
    init = cls.init

    def fast(self, rng, *args, **kwargs):
        return jax.jit(lambda r, a, k: init(self, r, *a, **k))(rng, args, kwargs)

    return init, fast


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import validate_checkpoint as vc

    path = tmp_path_factory.mktemp("synth") / "colqwen2-tiny"
    init, jq.ColQwen2.init = _jit_init(jq.ColQwen2)
    try:
        vc.make_synth_colqwen2(str(path))
    finally:
        jq.ColQwen2.init = init
    return str(path)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """Both packages' ``load_retriever`` in fp32 on the CPU."""
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    return jax_model, variables, jax_proc, model, proc


def _pages():
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
            for s, hw in enumerate(PAGE_SHAPES)]


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in batch.items() if k != "image_grid_thw"}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if k != "image_grid_thw"}


INTEGER_KEYS = ("input_ids", "attention_mask", "patch_mask", "vision_hpos", "vision_wpos", "position_ids",
                "image_grid_thw")


@pytest.mark.parametrize("device_pixels", [False, True])
def test_processor_pages_match_jax(loaded, device_pixels):
    jax_proc, proc = loaded[2], loaded[4]
    got = proc.process_images(_pages(), device_pixels=device_pixels)
    want = jax_proc.process_images(_pages(), device_pixels=device_pixels)
    assert set(got) == set(want)
    for key in INTEGER_KEYS:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    pixels = got["pixel_values"]
    assert isinstance(pixels, torch.Tensor) == device_pixels
    pixels = np.asarray(pixels)
    np.testing.assert_allclose(pixels, fp64_patches(_pages(), proc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pixels, np.asarray(want["pixel_values"]), atol=1e-4, rtol=0)
    assert pixels.shape[1] % 4 == 0 and (np.asarray(got["patch_mask"]).sum(1) % 4 == 0).all()


def fp64_patches(pages, proc) -> np.ndarray:
    """The pages resized with ``jax.image.resize``'s own weight matrices
    (``compute_weight_mat``) contracted in fp64, normalized, patchified and
    padded: what both packages' fp32 pixels approximate. On these pages JAX's
    compiled resize sits up to 2.2e-5 from it (the upscale to 56 x 84: XLA
    normalizes the weights with a low-precision reciprocal, as in
    test_torch_processor_surface.py), the port within 1.1e-6."""
    from jax._src.image import scale as jax_scale

    from colpali_tpu_torch.processors.qwen2_vl import patchify, smart_resize

    kernel = jax_scale._kernels[jax_scale.ResizeMethod.from_string("bicubic")]
    flats = []
    for page in pages:
        target = smart_resize(*page.shape[:2], 28, proc.min_pixels, proc.max_pixels)
        x = page.astype(np.float64)
        for axis, n in enumerate(target):
            m = x.shape[axis]
            if m != n:
                w = np.asarray(jax_scale.compute_weight_mat(m, n, jnp.float32(n / m), jnp.float32(0.0), kernel, True),
                               np.float64)
                x = np.moveaxis(np.tensordot(w, np.moveaxis(x, axis, 0), axes=([0], [0])), 0, axis)
        x = (x / 255.0 - np.asarray(proc.image_mean)) / np.asarray(proc.image_std)
        flats.append(patchify(x.transpose(2, 0, 1))[0])
    out = np.zeros((len(flats), -(-max(len(f) for f in flats) // 4) * 4, flats[0].shape[1]))
    for i, f in enumerate(flats):
        out[i, : len(f)] = f
    return out


def test_processor_queries_and_surface_match_jax(loaded):
    jax_proc, proc = loaded[2], loaded[4]
    got, want = proc.process_queries(QUERIES), jax_proc.process_queries(QUERIES)
    assert set(got) == set(want) == {"input_ids", "attention_mask", "position_ids"}
    for key in got:
        assert np.array_equal(got[key], want[key]), key
    assert (got["attention_mask"][:, 0] == 0).any()  # left padding
    assert proc.max_pixels == jax_proc.max_pixels == 768 * 28 * 28  # load_retriever's default budget
    for size in ((1275, 1650), (1650, 1275), (300, 40)):
        assert proc.get_n_patches(size) == jax_proc.get_n_patches(size)
    assert proc._export_configs() == jax_proc._export_configs()


def test_rope_tables_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 900, size=(3, 2, 11))
    want = jq.mrope_cos_sin(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    got = tq.mrope_cos_sin(torch.from_numpy(pos), 128, 1e6, (16, 24, 24))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    hpos, wpos = (torch.from_numpy(rng.integers(0, 62, size=(2, 16)).astype(np.int32)) for _ in range(2))
    cos, sin = tq.vision_rope(hpos, wpos, 80)
    inv = 1.0 / (10000.0 ** (np.arange(20, dtype=np.float32) * 2 / 40))
    emb = np.concatenate([hpos.numpy()[..., None] * inv, wpos.numpy()[..., None] * inv], -1)
    np.testing.assert_allclose(cos.numpy(), np.cos(np.concatenate([emb, emb], -1)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.sin(np.concatenate([emb, emb], -1)), atol=1e-5, rtol=0)


def test_state_dict_is_jax_tree_bit_for_bit(loaded, ckpt):
    variables, model = loaded[1], loaded[3]
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    assert detect_family({"architectures": ["ColQwen2_5"]}) == "colqwen2_5"
    assert detect_family({"model_type": "qwen2_vl"}) == "colqwen2"


def test_vision_tower_and_decoder_match_jax(loaded):
    jax_model, variables, jax_proc, model, proc = loaded
    cfg = jax_model.config
    batch = proc.process_images(_pages())
    params = variables["params"]["model"]
    want = np.asarray(jax.jit(jq.Qwen2VisionTower(cfg.vision).apply)(
        {"params": params["visual"]}, *(jnp.asarray(batch[k]) for k in ("pixel_values", "vision_hpos",
                                                                         "vision_wpos", "patch_mask"))))
    with torch.no_grad():
        got = model.model.visual(*(torch.from_numpy(np.asarray(batch[k])) for k in (
            "pixel_values", "vision_hpos", "vision_wpos", "patch_mask"))).numpy()
    valid = np.asarray(batch["patch_mask"]).reshape(len(PAGE_SHAPES), -1, 4).all(-1)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)

    rng = np.random.default_rng(1)
    q = proc.process_queries(QUERIES)
    embeds = rng.normal(size=(*q["input_ids"].shape, cfg.text.hidden_size)).astype(np.float32)
    decoder = jq.Qwen2Decoder(cfg.text)
    bias = jq.make_attention_bias(jnp.asarray(q["attention_mask"]), causal=True)
    want = np.asarray(jax.jit(decoder.apply)({"params": params["language_model"]}, jnp.asarray(embeds), bias,
                                             jnp.asarray(q["position_ids"])))
    with torch.no_grad():
        got = model.model.language_model(torch.from_numpy(embeds), torch.from_numpy(q["attention_mask"]),
                                         torch.from_numpy(q["position_ids"])).numpy()
    mask = q["attention_mask"].astype(bool)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["pages", "queries", "text_positions"])
def test_colqwen2_matches_jax(loaded, kind):
    jax_model, variables, jax_proc, model, proc = loaded
    batch = proc.process_images(_pages()) if kind == "pages" else proc.process_queries(QUERIES)
    if kind == "text_positions":  # no position_ids: the backbone takes them from the left-padded mask
        batch.pop("position_ids")
    want = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
    with torch.no_grad():
        got = model(**_torch(batch)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    mask = np.asarray(batch["attention_mask"]).astype(bool)
    assert (np.abs(np.linalg.norm(got[mask], axis=-1) - 1) < 1e-5).all() and not got[~mask].any()


def test_each_package_reads_the_others_export(loaded, ckpt, tmp_path):
    jax_model, variables, _, model, _ = loaded
    ours = export_colqwen2_state_dict(model.state_dict())
    theirs = jax_export(jax.tree.map(np.asarray, variables["params"]))
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert np.array_equal(ours[key].numpy(), np.asarray(value)), key
    assert ours["model.visual.patch_embed.proj.weight"].shape == (64, 3, 2, 14, 14)
    assert "model.visual.blocks.0.attn.qkv.weight" in ours
    save_pretrained(str(tmp_path), model.state_dict(), config=model.config)
    back = jax_load_params(str(tmp_path))
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(np.asarray(node), np.asarray(leaf)), path
    safetensors.save_file({k: np.asarray(v) for k, v in theirs.items()}, str(tmp_path / "model.safetensors"))
    again = load_colqwen2_params(str(tmp_path))
    for key, value in model.state_dict().items():
        assert torch.equal(again[key], value), key


@pytest.mark.parametrize("n", [1, 3, 5])
def test_query_encoder_pads_rope_positions_as_jax(loaded, n):
    jax_model, variables, jax_proc, model, proc = loaded
    texts = [QUERIES[i % len(QUERIES)] + " page" * i for i in range(n)]
    batch = proc.process_queries(texts)
    got, n_got = QueryEncoder(model, proc)._pad_static(batch)
    want, n_want = JaxQueryEncoder(jax_model, variables, jax_proc)._pad_static(batch)
    assert n_got == n_want == n and set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape and np.array_equal(got[key], want[key]), key
    assert got["position_ids"].shape == (3, *got["input_ids"].shape)
    embs = QueryEncoder(model, proc).encode(texts)
    assert [e.shape[0] for e in embs] == batch["attention_mask"].sum(1).tolist()
