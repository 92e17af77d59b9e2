"""Port parity: ColIdefics3 (ColSmol, Idefics3/SmolVLM) in colpali_tpu_torch
against colpali_tpu, on the CPU, on JAX's einsum route (no Pallas).

- ``pixel_shuffle`` on inputs that are not symmetric (a wrong order of its
  reshapes keeps the shape and scrambles the tokens), exactly; the bucketed
  patch position ids (not an arange); the vision tower at atol 1e-5.
- The processor on ``make_synth_colsmol(tiny=True)``'s checkpoint (64 px
  tiles, longest edge 256, 4 tokens a tile): ids, mask and ``tile_mask``
  exactly on a batch of three page sizes (a page over the longest edge, a
  3 x 2 grid, a single tile), right-padded; pixels within 1e-5 of
  ``jax.image.resize``'s weights contracted in fp64 and within 1e-4 of
  JAX's pixels, on the host and the device path.
- ``ColIdefics3`` on those pages and on right-padded queries, fp32, and
  ``embed_dataset`` / ``QueryEncoder`` against JAX's: atol 2e-5 on the
  L2-normalized output.
- Checkpoints: ``load_retriever(family="colidefics3")`` against JAX's (the
  state dicts bit for bit), each package reading the other's export bit for
  bit, ``save_pretrained`` from an ``Idefics3Config``, and
  ``write_idefics3_checkpoint`` read back by both packages.
- Stored int8 on a model at colSmol's projection widths (vision 768, MLP
  3,072, the 12,288 -> 576 connector, text 576 with 576 -> 192 k/v):
  ``quantize_params`` picks JAX's layers and gives its bytes bit for bit;
  the forward against JAX's ``(qp, qc)`` by per-token cosine (mean >=
  0.9999, min >= 0.999: an ulp of fp32 sum order can flip an int8
  activation; the same model in fp32 holds atol 2e-5).
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
from colpali_tpu.core.hf_export import export_colidefics3_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import load_colidefics3_params as jax_load_params  # noqa: E402
from colpali_tpu.evaluation.evaluator import embed_dataset as jax_embed_dataset  # noqa: E402
from colpali_tpu.models import idefics3 as ji  # noqa: E402
from colpali_tpu.models.qwen2_vl import Qwen2TextConfig as JaxTextConfig  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.retrieval.serving import QueryEncoder as JaxQueryEncoder  # noqa: E402
from colpali_tpu_torch.auto import detect_family, exporter_for, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colidefics3_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colidefics3_params  # noqa: E402
from colpali_tpu_torch.evaluation.evaluator import embed_dataset  # noqa: E402
from colpali_tpu_torch.models import idefics3 as ti  # noqa: E402
from colpali_tpu_torch.models.common import hf_init_  # noqa: E402
from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.processors.idefics3 import crop_bounds, resized_dimensions  # noqa: E402
from colpali_tpu_torch.retrieval.serving import QueryEncoder  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402
from colpali_tpu_torch.utils.testing import idefics3_word_tokenizer, write_idefics3_checkpoint  # noqa: E402

ATOL = 2e-5
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999
QUERIES = ["what is the total revenue ?", "a", "find document page 0 quarterly report"]
PAGE_SHAPES = ((300, 200), (150, 100), (60, 40))  # over the longest edge (4 x 3 tiles), 3 x 2 tiles, one tile


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import validate_checkpoint as vc

    path = tmp_path_factory.mktemp("synth") / "colsmol-tiny"
    vc.make_synth_colsmol(str(path), tiny=True)
    return str(path)


@pytest.fixture(scope="module")
def loaded(ckpt):
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    return jax_model, variables, jax_proc, model, proc


@pytest.fixture(scope="module")
def jax_apply(loaded):
    return jax.jit(loaded[0].apply)


def _pages(shapes=PAGE_SHAPES):
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8) for s, hw in enumerate(shapes)]


def _torch(batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("r,side,dim", [(2, 4, 6), (4, 8, 3), (2, 6, 5)])
def test_pixel_shuffle_matches_jax(r, side, dim):
    x = np.random.default_rng(side).normal(size=(3, side * side, dim)).astype(np.float32)
    got = ti.pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(ji.pixel_shuffle(jnp.asarray(x), r)))
    # token 1 gathers the second r x r block of the first block row: patches (i, r + j)
    x = np.arange(side * side, dtype=np.float32)[None, :, None]
    got = ti.pixel_shuffle(torch.from_numpy(x), r)[0, 1].numpy()
    assert list(got) == [i * side + r + j for i in range(r) for j in range(r)]


def test_bucketed_position_ids_are_not_an_arange():
    ids = ti.bucketed_position_ids(64, 16)  # side 4
    assert list(ids.reshape(4, 4)[:, 0]) == [0, 0, 4, 8] and list(ids[:4]) == [0, 0, 1, 2]  # coordinates 0, 0, 1, 2
    assert ids.shape == (16,) and not np.array_equal(ids, np.arange(16))


def test_vision_tower_matches_jax(loaded):
    jax_model, variables, _, model, _ = loaded
    cfg = jax_model.config.vision
    tiles = np.random.default_rng(3).normal(size=(5, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tower = ji.Idefics3VisionTower(cfg)
    want = np.asarray(jax.jit(tower.apply)({"params": variables["params"]["model"]["vision_model"]},
                                           jnp.asarray(tiles)))
    with torch.no_grad():
        got = model.model.vision_model(torch.from_numpy(tiles)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def fp64_tiles(pages, proc) -> np.ndarray:
    """The tiles with ``jax.image.resize``'s own weight matrices
    (``compute_weight_mat``) contracted in fp64 (the longest-edge resize,
    each crop, the global view), normalized and padded: what both packages'
    fp32 tiles approximate."""
    from jax._src.image import scale as jax_scale

    kernel = jax_scale._kernels[jax_scale.ResizeMethod.from_string("bicubic")]
    weights = jax.jit(jax_scale.compute_weight_mat, static_argnums=(0, 1, 4, 5))  # one compile a (m, n)

    def resize(x, target):
        for axis, n in enumerate(target):
            m = x.shape[axis]
            if m != n:
                w = np.asarray(weights(m, n, jnp.float32(n / m), jnp.float32(0.0), kernel, True), np.float64)
                x = np.moveaxis(np.tensordot(w, np.moveaxis(x, axis, 0), axes=([0], [0])), 0, axis)
        return x

    s, out = proc.tile_size, []
    for page in pages:
        h0, w0 = page.shape[:2]
        h1, w1 = resized_dimensions(h0, w0, proc.longest_edge if max(h0, w0) > proc.longest_edge else None)
        x = resize(page.astype(np.float64), (h1, w1))
        tiles = [resize(x[r0:r1, c0:c1], (s, s)) for r0, r1, c0, c1 in crop_bounds(h1, w1, s)[2]]
        out.append((np.stack(tiles) / 255.0 - np.asarray(proc.image_mean)) / np.asarray(proc.image_std))
    padded = np.zeros((len(out), max(len(t) for t in out), s, s, 3))
    for i, t in enumerate(out):
        padded[i, : len(t)] = t
    return padded


@pytest.fixture(scope="module")
def jax_pages(loaded):
    """JAX's batch of :func:`_pages` (its device path: one compiled program a
    shape group; its host path computes the same resizes one call each)."""
    return loaded[2].process_images(_pages(), device_pixels=True)


@pytest.mark.parametrize("device_pixels", [False, True])
def test_processor_pages_match_jax(loaded, jax_pages, device_pixels):
    proc = loaded[4]
    assert (proc.tile_size, proc.longest_edge, proc.image_seq_len) == (64, 256, 4)
    got = proc.process_images(_pages(), device_pixels=device_pixels)
    want = jax_pages
    assert set(got) == set(want) == {"input_ids", "attention_mask", "pixel_values", "tile_mask"}
    for key in ("input_ids", "attention_mask", "tile_mask"):
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    assert np.asarray(got["tile_mask"]).sum(1).tolist() == [13, 7, 1]
    mask = np.asarray(got["attention_mask"])
    assert mask[0].all() and not mask[2].all() and (np.diff(mask, axis=1) <= 0).all()  # right padding
    pixels = got["pixel_values"]
    assert isinstance(pixels, torch.Tensor) == device_pixels
    pixels = np.asarray(pixels)
    np.testing.assert_allclose(pixels, fp64_tiles(_pages(), proc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pixels, np.asarray(want["pixel_values"]), atol=1e-4, rtol=0)


def test_processor_queries_host_resize_and_surface_match_jax(loaded):
    jax_proc, proc = loaded[2], loaded[4]
    got, want = proc.process_queries(QUERIES), jax_proc.process_queries(QUERIES)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    got = proc.process_images(_pages(), host_resize=True, device_pixels=True)
    want = jax_proc.process_images(_pages(), host_resize=True, device_pixels=True)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_allclose(got["pixel_values"].numpy(), want["pixel_values"], atol=1e-4, rtol=0)
    batch = proc.process_images(_pages())
    np.testing.assert_array_equal(proc.get_image_mask(batch), jax_proc.get_image_mask(batch))
    np.testing.assert_array_equal(proc.get_local_image_mask(batch), jax_proc.get_local_image_mask(batch))
    for hw in ((300, 200), (60, 40), (1650, 1275)):
        assert proc.get_n_patches(hw) == jax_proc.get_n_patches(hw)
        assert proc._image_prompt(*crop_bounds(*hw, 64)[:2]) == jax_proc._image_prompt(*crop_bounds(*hw, 64)[:2])
    assert proc._export_configs() == jax_proc._export_configs()


def test_colidefics3_matches_jax_on_pages_and_right_padded_queries(loaded, jax_apply):
    variables, proc, model = loaded[1], loaded[4], loaded[3]
    for batch in (proc.process_images(_pages()), proc.process_queries(QUERIES)):
        want = np.asarray(jax_apply(variables, **_jax(batch)))
        with torch.no_grad():
            got = model(**_torch(batch)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert np.isfinite(got).all()


def test_embed_dataset_and_query_encoder_match_jax(loaded, jax_apply):
    jax_model, variables, jax_proc, model, proc = loaded
    pages = _pages()
    want = jax_embed_dataset(jax_apply, variables, jax_proc, pages, batch_size=2)
    got = embed_dataset(model, proc, pages, batch_size=2)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    want = JaxQueryEncoder(jax_model, variables, jax_proc).encode(QUERIES)
    got = QueryEncoder(model, proc).encode(QUERIES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_load_retriever_matches_jax_and_checkpoints_cross_bit_for_bit(loaded, ckpt, tmp_path):
    jax_model, variables, jax_proc, model, proc = loaded
    assert detect_family({"architectures": ["ColIdefics3"]}) == "colidefics3"
    assert type(model).__name__ == "ColIdefics3" and model.config.image_token_id == jax_model.config.image_token_id
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # the port's export read by JAX, JAX's export read by the port
    (tmp_path / "port").mkdir()
    safetensors.save_file(export_colidefics3_state_dict(got), str(tmp_path / "port" / "model.safetensors"))
    back = jax_load_params(str(tmp_path / "port"))
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    (tmp_path / "jax").mkdir()
    safetensors.save_file({k: torch.from_numpy(np.array(v)) for k, v in jax_export(variables["params"]).items()},
                          str(tmp_path / "jax" / "model.safetensors"))
    for key, value in load_colidefics3_params(str(tmp_path / "jax")).items():
        assert torch.equal(value, got[key]), key
    # save_pretrained picks the family's exporter from the config
    assert exporter_for(model.config) == exporter_for(jax_model.config) == "export_colidefics3_state_dict"
    save_pretrained(str(tmp_path / "export"), got, config=model.config)
    for key, value in load_colidefics3_params(str(tmp_path / "export")).items():
        assert torch.equal(value, got[key]), key


def test_write_idefics3_checkpoint_is_read_by_both_packages(tmp_path):
    cfg = ti.Idefics3Config(
        vision=ti.Idefics3VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                       num_attention_heads=2, image_size=32, patch_size=8),
        text=Qwen2TextConfig(vocab_size=49280, hidden_size=48, intermediate_size=96, num_hidden_layers=1,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=12, rope_theta=100000.0,
                             mrope_section=(6,), attention_bias=False),
        scale_factor=2, image_token_id=49190)
    model = ti.ColIdefics3(cfg, device="cpu")
    hf_init_(model, torch.Generator().manual_seed(0))
    tok = idefics3_word_tokenizer("describe the image . user: assistant: what is revenue".split())
    write_idefics3_checkpoint(str(tmp_path), model, tok)
    loaded, proc = load_retriever(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (proc.tile_size, proc.longest_edge, proc.image_seq_len) == (32, 128, 4)
    assert proc.image_token_id == 49190 and loaded.config == cfg
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    jax_model, variables, jax_proc = jax_load_retriever(str(tmp_path), dtype=jnp.float32, param_dtype=jnp.float32)
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    for key, value in want.items():
        assert torch.equal(model.state_dict()[key], value), key
    batch = proc.process_images(_pages(((70, 40),)))
    np.testing.assert_array_equal(batch["input_ids"], jax_proc.process_images(_pages(((70, 40),)))["input_ids"])


# -- stored int8 at colSmol's widths ---------------------------------------------------

WIDE_VISION = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=1, num_attention_heads=12,
                   image_size=64, patch_size=16)
WIDE_TEXT = dict(vocab_size=64, hidden_size=576, intermediate_size=1536, num_hidden_layers=1, num_attention_heads=9,
                 num_key_value_heads=3, head_dim=64, rope_theta=100000.0, rms_norm_eps=1e-5, mrope_section=(32,),
                 attention_bias=False)


def test_quantize_params_at_colsmol_widths_matches_jax():
    jcfg = ji.Idefics3Config(vision=ji.Idefics3VisionConfig(**WIDE_VISION), text=JaxTextConfig(**WIDE_TEXT),
                             scale_factor=4, image_token_id=5)
    jax_model = ji.ColIdefics3(jcfg, dim=128)
    rng = np.random.default_rng(0)
    ids = rng.integers(6, 64, size=(2, 9)).astype(np.int32)
    ids[:, 1:3] = 5  # two tiles of one token each
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "pixel_values": rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)}
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), **_jax(batch))["params"]
    params = jax.tree.map(np.asarray, params)
    qp, qc = jqd.quantize_params(params)
    port_cfg = ti.Idefics3Config(vision=ti.Idefics3VisionConfig(**WIDE_VISION), text=Qwen2TextConfig(**WIDE_TEXT),
                                 scale_factor=4, image_token_id=5)
    model = ti.ColIdefics3(port_cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(model)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths)
    assert "model/modality_projection/kernel" in paths  # 12,288 -> 576
    assert "model/text_model/layers_0/self_attn/k_proj/kernel" not in paths  # 576 -> 192: exact by shape
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key

    float_model = ti.ColIdefics3(port_cfg, device="cpu").eval()
    float_model.load_state_dict(state_dict_from_jax(params))
    valid = mask.astype(bool)
    for m, variables in ((float_model, {"params": params}), (model, {"params": qp, "quant": qc})):
        want_out = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
        with torch.no_grad():
            got_out = m(**_torch(batch)).numpy()
        if m is float_model:
            np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=0)
            continue
        a, b = got_out[valid], want_out[valid]
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.mean() >= QUANT_COS_MEAN and cos.min() >= QUANT_COS_MIN, (cos.mean(), cos.min())
