"""Port parity: the Gemma3 family (ColGemma3, BiGemma3) in colpali_tpu_torch
against colpali_tpu, on the CPU, fp32.

The model is ``scripts/gate_families.py``'s synthetic Gemma3 with its text
scale moved off the head dim: a 2-layer SigLIP tower (32 wide, 4 heads) over
112 px pages (an 8 x 8 patch grid pooled to 16 soft tokens), a 3-layer
decoder (32 wide, GQA 4/2 x 8) with ``sliding_window`` 4 (shorter than every
sequence), ``sliding_window_pattern`` 2, ``rope_scaling_factor`` 2 and
``query_pre_attn_scalar`` 5 (not the head dim, 8). Every weight (norms and
biases too) is drawn from a seeded numpy generator and carried into the
port by ``core/from_jax.py``.

- ``gemma3_attention_bias`` exactly (sliding window, image blocks at
  different offsets of left-padded rows, padded keys); the biased attention
  path (q/k norms, the scale, GQA) chunked and dense against JAX's at atol
  2e-5, and refused beside a mask.
- ``ColGemma3`` pages with and without ``mask_non_image_embeddings`` (left
  padding puts the image blocks at different offsets), left-padded queries
  (a pad row at position 0 sees no key: a uniform softmax, finite), and
  ``BiGemma3`` with ``embedding_dim``: atol 2e-5.
- The processor's ids, mask and pixels against JAX's, with a tokenizer the
  test writes (Gemma3's specials); HF state dicts across both packages bit
  for bit; ``load_retriever(family="colgemma3")`` on a
  ``write_gemma3_checkpoint`` directory against JAX's.
- Stored int8 at widths past ``min_dim`` (vision 512, text 512 with 8/4
  heads of 128): the port's ``quantize_params`` picks JAX's layers and
  bytes bit for bit, the forward per token (mean cos >= 0.9999, min >=
  0.999); at Gemma3-4B's full width JAX's ``quantize_params`` over the
  abstract tree stores 400 layers (34 x 7 text + 27 x 6 vision) and the
  port's, over a model on the ``meta`` device, the same paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.auto import load_retriever as jax_load_retriever
from colpali_tpu.core.hf_export import export_colgemma3_state_dict as jax_export
from colpali_tpu.core.hf_loader import load_colgemma3_params as jax_load_params
from colpali_tpu.models import gemma3 as jg
from colpali_tpu.models import layers as jl
from colpali_tpu.models.configs import SiglipVisionConfig as JaxVisionConfig
from colpali_tpu.ops import quant_dense as jqd
from colpali_tpu.processors import gemma3 as jpg
from colpali_tpu_torch.auto import _NOT_PORTED, detect_family, exporter_for, load_retriever
from colpali_tpu_torch.core import safetensors
from colpali_tpu_torch.core.from_jax import state_dict_from_jax
from colpali_tpu_torch.core.hf_export import export_colgemma3_state_dict
from colpali_tpu_torch.core.hf_loader import load_colgemma3_params
from colpali_tpu_torch.models import gemma3 as tg
from colpali_tpu_torch.models.configs import SiglipVisionConfig
from colpali_tpu_torch.models.layers import Attention, QDense, apply_rope, biased_attention, rope_cos_sin
from colpali_tpu_torch.ops import quant_dense as qd
from colpali_tpu_torch.processors import gemma3 as tpg
from colpali_tpu_torch.training.checkpointing import save_pretrained
from colpali_tpu_torch.utils.testing import gemma3_word_tokenizer, write_gemma3_checkpoint

ATOL = 2e-5
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999
IMAGE_TOKEN = 7
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=112,
              patch_size=14)
TEXT = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, query_pre_attn_scalar=5.0, sliding_window=4, sliding_window_pattern=2,
            rope_theta=1_000_000.0, rope_local_base_freq=10_000.0, rope_scaling_factor=2.0, rms_norm_eps=1e-6)
QUERIES = ["what is the total revenue ?", "a", "find the quarterly report of the company"]
PROMPTS = ["Describe this image", "image", "Describe this image of the quarterly report"]
PAGE_SHAPES = ((150, 120), (90, 200), (112, 112))


def configs(vision=VISION, text=TEXT, tokens=16):
    """(JAX config, the port's) of the same widths."""
    return (jg.Gemma3Config(vision=JaxVisionConfig(**vision), text=jg.Gemma3TextConfig(**text),
                            mm_tokens_per_image=tokens, image_token_index=IMAGE_TOKEN),
            tg.Gemma3Config(vision=SiglipVisionConfig(**vision), text=tg.Gemma3TextConfig(**text),
                            mm_tokens_per_image=tokens, image_token_index=IMAGE_TOKEN))


def seeded_params(jax_model, feed, seed=0, scale=0.1):
    """JAX's parameter tree of ``jax_model`` (shapes by ``eval_shape``, no
    compile), every leaf drawn from a seeded numpy normal times ``scale``."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), *feed)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32), shapes)


def tokenizer():
    return gemma3_word_tokenizer(" ".join(QUERIES + PROMPTS).split(), IMAGE_TOKEN)


def pages():
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
            for s, hw in enumerate(PAGE_SHAPES)]


def _jax(batch):
    return [jnp.asarray(np.asarray(batch[k])) for k in ("input_ids", "attention_mask", "pixel_values") if k in batch]


def _torch(batch):
    return [torch.as_tensor(np.asarray(batch[k])) for k in ("input_ids", "attention_mask", "pixel_values")
            if k in batch]


@pytest.fixture(scope="module")
def procs():
    tok = tokenizer()
    return (jpg.ColGemma3Processor(tok, image_size=112, image_seq_length=16),
            tpg.ColGemma3Processor(tok, image_size=112, image_seq_length=16, device="cpu"))


@pytest.fixture(scope="module")
def batches(procs):
    proc = procs[1]
    return proc.process_images(pages(), context_prompts=PROMPTS), proc.process_queries(QUERIES)


@pytest.fixture(scope="module")
def weights(batches):
    jcfg = configs()[0]
    return seeded_params(jg.ColGemma3(jcfg), _jax(batches[0]))


def test_attention_bias_matches_jax():
    b, s = 3, 19
    mask = (np.arange(s)[None] >= np.array([0, 3, 7])[:, None]).astype(np.int32)  # left padding
    image = np.zeros((b, s), bool)
    for row, (start, n) in enumerate(((2, 6), (5, 6), (9, 3))):
        image[row, start:start + n] = True
    image[0, 12:15] = True  # a second block in one row
    for window in (None, 4, 1):
        for img in (None, image):
            want = np.asarray(jg.gemma3_attention_bias(jnp.asarray(mask), None if img is None else jnp.asarray(img),
                                                       window))
            got = tg.gemma3_attention_bias(torch.from_numpy(mask), None if img is None else torch.from_numpy(img),
                                           window).numpy()
            assert got.dtype == np.float32 and got.shape == (b, 1, s, s)
            np.testing.assert_array_equal(got, want)
    allowed = got[0, 0] == 0
    assert allowed[7, 2] and allowed[2, 7] and not allowed[12, 2]  # one block both ways, window 1 elsewhere
    assert not (got[2, 0] == 0)[0].any()  # a pad row at position 0 sees no valid key


@pytest.mark.parametrize("q_chunk", [None, 5, 64])
def test_biased_attention_chunked_and_dense_match_jax(q_chunk):
    rng = np.random.default_rng(2)
    b, s, width, h, hkv, d = 2, 13, 24, 4, 2, 8
    scale = 5.0**-0.5
    x = rng.normal(size=(b, s, width)).astype(np.float32)
    mask = (np.arange(s)[None] >= np.array([0, 4])[:, None]).astype(np.int32)
    image = np.zeros((b, s), bool)
    image[0, 3:9] = image[1, 6:12] = True
    bias = jg.gemma3_attention_bias(jnp.asarray(mask), jnp.asarray(image), 3)
    pos = np.broadcast_to(np.arange(s), (b, s))
    rope = jl.rope_cos_sin(jnp.asarray(pos), d, 10_000.0)
    jattn = jl.Attention(num_heads=h, head_dim=d, num_kv_heads=hkv, scale=scale, qk_norm_eps=1e-6, q_chunk=q_chunk)
    params = jax.tree.map(lambda a: (np.random.default_rng(3).normal(size=a.shape) * 0.2).astype(np.float32),
                          jax.eval_shape(jattn.init, jax.random.PRNGKey(0), jnp.asarray(x), bias, rope)["params"])
    want = np.asarray(jattn.apply({"params": params}, jnp.asarray(x), bias, rope))
    attn = Attention(width, h, d, num_kv_heads=hkv, scale=scale, qk_norm_eps=1e-6, device="cpu")
    state = state_dict_from_jax({"model": {"language_model": {"layers_0": {"self_attn": params}}}})
    attn.load_state_dict({k.rpartition("self_attn.")[2]: v for k, v in state.items()})
    xt, tbias = torch.from_numpy(x), torch.from_numpy(np.asarray(bias))
    cos_sin = rope_cos_sin(torch.from_numpy(pos.copy()), d, 10_000.0)
    with torch.no_grad():
        got = attn(xt, rope=cos_sin, attn_bias=tbias).numpy()  # the chunk from the logits budget: one here
        q = apply_rope(attn.q_norm(attn.q_proj(xt).view(b, s, h, d)), *cos_sin)
        k = apply_rope(attn.k_norm(attn.k_proj(xt).view(b, s, hkv, d)), *cos_sin)
        v = attn.v_proj(xt).view(b, s, hkv, d)
        chunked = attn.o_proj(biased_attention(q, k, v, tbias, scale, q_chunk).reshape(b, s, h * d)).numpy()
    for out in (got, chunked):
        np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
        assert np.isfinite(out).all()  # row 1's pad rows at positions 0-3 see no valid key: a uniform softmax
    with pytest.raises(ValueError, match="attn_bias"):
        attn(torch.from_numpy(x), attn_bias=torch.from_numpy(np.asarray(bias)), mask=torch.from_numpy(mask))


@pytest.mark.parametrize("mask_non_image", [False, True])
def test_colgemma3_pages_match_jax(batches, weights, mask_non_image):
    jcfg, cfg = configs()
    page_batch = batches[0]
    ids = np.asarray(page_batch["input_ids"])
    starts = [int(np.argmax(row == IMAGE_TOKEN)) for row in ids]
    assert len(set(starts)) == 3 and ids.shape[1] > TEXT["sliding_window"] + 16  # blocks at different offsets
    want = np.asarray(jax.jit(jg.ColGemma3(jcfg, mask_non_image_embeddings=mask_non_image).apply)(
        {"params": weights}, *_jax(page_batch)))
    model = tg.ColGemma3(cfg, mask_non_image_embeddings=mask_non_image, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(weights))
    with torch.no_grad():
        got = model(*_torch(page_batch)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all() and np.abs(got).max() > 0.1
    if mask_non_image:
        assert not got[ids != IMAGE_TOKEN].any()


def test_left_padded_queries_and_bigemma3_match_jax(batches, weights):
    jcfg, cfg = configs()
    query_batch = batches[1]
    mask = np.asarray(query_batch["attention_mask"])
    assert (mask[:, 0] == 0).sum() == 2 and mask[:, -1].all()  # left padding
    want = np.asarray(jax.jit(jg.ColGemma3(jcfg).apply)({"params": weights}, *_jax(query_batch)))
    model = tg.ColGemma3(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(weights))
    with torch.no_grad():
        got = model(*_torch(query_batch)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all()

    base = {"model": weights["model"]}
    bi = tg.BiGemma3(cfg, embedding_dim=16, device="cpu").eval()
    bi.load_state_dict(state_dict_from_jax(base))
    japply = jax.jit(jg.BiGemma3(jcfg, embedding_dim=16).apply)
    for batch in batches:
        want = np.asarray(japply({"params": base}, *_jax(batch)))
        with torch.no_grad():
            got = bi(*_torch(batch)).numpy()
        assert got.shape == (len(want), 16)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_processor_matches_jax(procs):
    jproc, proc = procs
    for kw in ({}, {"context_prompts": PROMPTS}):
        got, want = proc.process_images(pages(), **kw), jproc.process_images(pages(), **kw)
        assert set(got) == set(want) == {"input_ids", "attention_mask", "pixel_values"}
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=1e-4, rtol=0)
    assert (np.asarray(got["input_ids"]) == IMAGE_TOKEN).sum(1).tolist() == [16] * 3
    got, want = proc.process_queries(QUERIES), jproc.process_queries(QUERIES)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["input_ids"][:, -1] == proc.tokenizer.convert_tokens_to_ids("<end_of_turn>")).all()  # no suffix
    np.testing.assert_array_equal(proc.process_texts(QUERIES)["input_ids"], got["input_ids"])
    device = proc.process_images(pages(), device_pixels=True)["pixel_values"]
    assert isinstance(device, torch.Tensor)
    batch = proc.process_images(pages())
    np.testing.assert_array_equal(proc.get_image_mask(batch), jproc.get_image_mask(batch))
    assert proc.get_n_patches((1650, 1275)) == jproc.get_n_patches((1650, 1275)) == (4, 4)
    assert proc._export_configs() == jproc._export_configs()
    assert proc.query_augmentation_token == jproc.query_augmentation_token == "<eos>"
    assert tpg.ColGemmaProcessor3 is tpg.ColGemma3Processor and tpg.BiGemmaProcessor3 is tpg.BiGemma3Processor


def test_hf_state_dicts_cross_bit_for_bit(weights, tmp_path):
    jcfg, cfg = configs()
    model = tg.ColGemma3(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(weights))
    got = model.state_dict()
    assert got["model.mm_input_projection"].shape == (VISION["hidden_size"], TEXT["hidden_size"])
    (tmp_path / "port").mkdir()
    safetensors.save_file(export_colgemma3_state_dict(got), str(tmp_path / "port" / "model.safetensors"))
    back = jax_load_params(str(tmp_path / "port"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(weights)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    (tmp_path / "jax").mkdir()
    safetensors.save_file({k: torch.from_numpy(np.array(v)) for k, v in jax_export(weights).items()},
                          str(tmp_path / "jax" / "model.safetensors"))
    assert set(safetensors.load_file(str(tmp_path / "jax" / "model.safetensors"))) == \
        set(export_colgemma3_state_dict(got))  # the same HF keys
    loaded = load_colgemma3_params(str(tmp_path / "jax"))
    assert set(loaded) == set(got)
    for key, value in loaded.items():
        assert torch.equal(value, got[key]), key
    assert exporter_for(cfg) == exporter_for(jcfg) == "export_colgemma3_state_dict"
    save_pretrained(str(tmp_path / "export"), got, config=cfg)  # the training export: config.json is asdict
    for key, value in load_colgemma3_params(str(tmp_path / "export")).items():
        assert torch.equal(value, got[key]), key


def test_load_retriever_reads_write_gemma3_checkpoint_like_jax(tmp_path):
    cfg = configs()[1]
    write_gemma3_checkpoint(str(tmp_path), cfg, seed=4, words=" ".join(QUERIES).split(), device="cpu")
    assert "colgemma3" not in _NOT_PORTED and detect_family({"architectures": ["ColGemma3"]}) == "colgemma3"
    model, proc = load_retriever(str(tmp_path), dtype=torch.float32, device="cpu")
    assert type(model).__name__ == "ColGemma3" and type(proc).__name__ == "ColGemma3Processor"
    assert model.config == cfg and proc.image_token_id == IMAGE_TOKEN
    assert (proc.image_size, proc.image_seq_length) == (112, 16)
    assert model.model.mm_input_projection.abs().max() > 0  # drawn, not HF's zeros
    jmodel, variables, jproc = jax_load_retriever(str(tmp_path), dtype=jnp.float32, param_dtype=jnp.float32)
    want_state = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert set(want_state) == set(model.state_dict())
    for key, value in want_state.items():
        assert torch.equal(model.state_dict()[key], value), key
    for batch, jbatch in ((proc.process_images(pages()), jproc.process_images(pages())),
                          (proc.process_queries(QUERIES), jproc.process_queries(QUERIES))):
        np.testing.assert_array_equal(batch["input_ids"], jbatch["input_ids"])
        want = np.asarray(jax.jit(jmodel.apply)(variables, *_jax(batch)))
        with torch.no_grad():
            got = model(*_torch(batch)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# -- stored int8 -----------------------------------------------------------------------------------------------

WIDE_VISION = dict(hidden_size=512, intermediate_size=1024, num_hidden_layers=1, num_attention_heads=4,
                   image_size=56, patch_size=14)
WIDE_TEXT = dict(TEXT, hidden_size=512, intermediate_size=1024, num_hidden_layers=2, num_attention_heads=8,
                 num_key_value_heads=4, head_dim=128, query_pre_attn_scalar=100.0)


def test_quantize_params_matches_jax_and_the_full_width_count():
    jcfg, cfg = configs(WIDE_VISION, WIDE_TEXT, tokens=4)
    rng = np.random.default_rng(5)
    ids = rng.integers(9, 128, size=(2, 11)).astype(np.int32)
    ids[:, 2:6] = IMAGE_TOKEN
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "pixel_values": rng.normal(size=(2, 56, 56, 3)).astype(np.float32)}
    jmodel = jg.ColGemma3(jcfg)
    params = seeded_params(jmodel, _jax(batch), seed=6, scale=0.05)
    qp, qc = jqd.quantize_params(params)
    model = tg.ColGemma3(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(model)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths) and len(paths) == 6 + 2 * 7  # k/v 512 -> 512 are stored too
    assert not any("mm_input_projection" in p for p in paths)  # a raw parameter, no Dense
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    want_out = np.asarray(jax.jit(jmodel.apply)({"params": qp, "quant": qc}, *_jax(batch)))
    with torch.no_grad():
        got_out = model(*_torch(batch)).numpy()
    valid = mask.astype(bool)
    a, b = got_out[valid], want_out[valid]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.mean() >= QUANT_COS_MEAN and cos.min() >= QUANT_COS_MIN, (cos.mean(), cos.min())

    # Gemma3-4B: JAX's quantize_params over the abstract parameter tree, the port's over a model on "meta"
    full = jg.Gemma3Config()
    s = 300
    shapes = jax.eval_shape(jg.ColGemma3(full).init, jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
                            jnp.ones((1, s), jnp.int32), jnp.zeros((1, 896, 896, 3), jnp.float32))["params"]
    full_qc = jax.eval_shape(lambda p: jqd.quantize_params(p)[1], shapes)
    full_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                  for path, _ in jax.tree_util.tree_flatten_with_path(full_qc)[0]]
    assert len(full_paths) == 34 * 7 + 27 * 6 == 400
    meta = tg.ColGemma3(tg.Gemma3Config(), device="meta", dtype=torch.bfloat16)
    assert sorted(qd.quantize_params(meta)) == sorted(full_paths)
    assert sum(isinstance(m, QDense) and m.stored for m in meta.modules()) == 400
    assert dataclasses.asdict(tg.Gemma3Config()) == dataclasses.asdict(full)
