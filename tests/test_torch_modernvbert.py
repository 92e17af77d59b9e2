"""Port parity: the ModernVBert family (ColModernVBert, BiModernVBert,
ModernVBertForMaskedLM) in colpali_tpu_torch against colpali_tpu, on the
CPU, fp32.

The checkpoint is ``scripts/gate_families.py::make_synth_colmodernvbert``'s:
a SigLIP tower 2 x 32 (4 heads of 8) over 32 px tiles of 8 px patches,
pixel shuffle 2 (4 tokens a tile), a ModernBERT encoder 3 x 48 (4 heads of
12, GeGLU 2 x 64) whose window of 4 (``|q - k| <= 2``) is shorter than
every row, global attention on layer 0 only, and 16 additional ids holding
the tile tokens (``<image>`` at 135, past the base vocabulary of 128).

- ``DecoupledEmbed`` exactly; ``ModernBertLayer`` (layer 0, whose
  ``attn_norm`` is the identity, and a local layer) and
  ``ModernBertEncoder`` at atol 2e-5, rows left-padded past the window (a
  query whose window holds only pads takes JAX's uniform average: finite);
  the encoder against ``transformers.ModernBertModel`` with random weights
  (no download).
- ``ColModernVBert`` on pages of 5, 3 and 1 tiles and on left-padded
  queries, with and without ``mask_non_image_embeddings``;
  ``BiModernVBert`` (cls, last, mean) and ``ModernVBertForMaskedLM``:
  atol 2e-5. A query alone and inside ``QueryEncoder``'s bucketed batch
  (left pads, then right pads with mask 0) agree.
- The processor's ids, mask and ``tile_mask`` exactly and its pixels at
  1e-4 of JAX's, padded on the left.
- HF state dicts across both packages bit for bit; ``load_retriever`` and
  ``serve.py --family colmodernvbert`` on a ``write_modernvbert_checkpoint``
  directory against JAX's ``load_retriever``.
- Stored int8 at widths past ``min_dim`` (vision and text 512): the port's
  ``quantize_params`` takes JAX's layers and bytes bit for bit, the forward
  per token (mean cos >= 0.9999, min >= 0.999); at ModernVBERT-base's full
  widths both store the same 205 layers.
"""

import dataclasses
import json
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.core.hf_export import export_colmodernvbert_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import load_colmodernvbert_params as jax_load_params  # noqa: E402
from colpali_tpu.models import modernvbert as jm  # noqa: E402
from colpali_tpu.models import layers as jl  # noqa: E402
from colpali_tpu.models.configs import SiglipVisionConfig as JaxVisionConfig  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu.processors import modernvbert as jpm  # noqa: E402
from colpali_tpu.retrieval.serving import QueryEncoder as JaxQueryEncoder  # noqa: E402
from colpali_tpu_torch import serve  # noqa: E402
from colpali_tpu_torch.auto import _NOT_PORTED, _PORTED, detect_family, exporter_for, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colmodernvbert_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colmodernvbert_params  # noqa: E402
from colpali_tpu_torch.models import modernvbert as tm  # noqa: E402
from colpali_tpu_torch.models.configs import SiglipVisionConfig  # noqa: E402
from colpali_tpu_torch.models.layers import QDense, rope_cos_sin  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.processors import modernvbert as tpm  # noqa: E402
from colpali_tpu_torch.retrieval.serving import QueryEncoder  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402
from colpali_tpu_torch.utils.testing import write_modernvbert_checkpoint  # noqa: E402

ATOL = 2e-5
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999
QUERIES = ["what is the total revenue ?", "a", "find document page 0 quarterly report"]
PAGE_SHAPES = ((100, 70), (60, 30), (30, 20))  # over the longest edge (2 x 2 tiles), 2 x 1 tiles, one tile
TEXT = dict(vocab_size=128, hidden_size=48, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            local_attention=4, global_attn_every_n_layers=3, norm_eps=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import gate_families

    path = str(tmp_path_factory.mktemp("synth") / "colmodernvbert-tiny")
    gate_families.make_synth_colmodernvbert(path)
    return path


@pytest.fixture(scope="module")
def loaded(ckpt):
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, proc = load_retriever(ckpt, family="colmodernvbert", dtype=torch.float32, device="cpu")
    return jax_model, variables, jax_proc, model, proc


@pytest.fixture(scope="module")
def jax_apply(loaded):
    return jax.jit(loaded[0].apply)


def _pages(shapes=PAGE_SHAPES):
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8) for s, hw in enumerate(shapes)]


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}


def seeded(shapes, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32), shapes)


def left_padded_mask(b_lens, s):
    return (np.arange(s)[None] >= s - np.asarray(b_lens)[:, None]).astype(np.int32)


def test_decoupled_embed_matches_jax_and_never_reads_the_base_table_past_it():
    emb = jm.DecoupledEmbed(vocab_size=10, additional_vocab_size=4, features=6)
    ids = np.array([[0, 3, 9, 10, 13], [11, 12, 1, 2, 10]], np.int32)
    params = seeded(jax.eval_shape(emb.init, jax.random.PRNGKey(0), jnp.asarray(ids))["params"], 1)
    want = np.asarray(emb.apply({"params": params}, jnp.asarray(ids)))
    port = tm.DecoupledEmbed(10, 4, 6, device="cpu")
    port.load_state_dict({k.removeprefix("model.embeddings."): v
                          for k, v in state_dict_from_jax({"model": {"embeddings": params}}).items()})
    with torch.no_grad():
        port.tok_embeddings.weight[0] = float("nan")  # an id past the base vocabulary must not read row 0
        got = port(torch.from_numpy(ids)).numpy()
    extra = ids >= 10
    np.testing.assert_array_equal(got[extra], want[extra])
    np.testing.assert_array_equal(got[~extra & (ids > 0)], want[~extra & (ids > 0)])


def _layer_inputs(cfg, b_lens, s, seed):
    rng = np.random.default_rng(seed)
    mask = left_padded_mask(b_lens, s)
    x = rng.normal(size=(len(b_lens), s, cfg.hidden_size)).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("layer_idx", [0, 1])
def test_modernbert_layer_matches_jax(layer_idx):
    cfg = jm.ModernBertTextConfig(**TEXT)
    x, mask = _layer_inputs(cfg, (11, 4), 11, 2)
    bias_g, bias_l = tm.modernbert_attention_biases(torch.from_numpy(mask), cfg.local_attention)
    b, s = mask.shape
    pos = np.broadcast_to(np.arange(s), (b, s))
    ropes = [jl.rope_cos_sin(jnp.asarray(pos), cfg.head_dim, th) for th in (cfg.global_rope_theta,
                                                                          cfg.local_rope_theta)]
    jlayer = jm.ModernBertLayer(cfg)
    args = (jnp.asarray(x), layer_idx, jnp.asarray(bias_g.numpy()), jnp.asarray(bias_l.numpy()), *ropes)
    params = seeded(jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), *args)["params"], 3 + layer_idx)
    want = np.asarray(jlayer.apply({"params": params}, *args))
    layer = tm.ModernBertLayer(tm.ModernBertTextConfig(**TEXT), layer_idx, device="cpu")
    layer.load_state_dict({k.removeprefix("model.text_model.layers.0."): v for k, v in state_dict_from_jax(
        {"model": {"text_model": {"layers_0": params}}}).items()})
    glob = layer.layer_idx % cfg.global_attn_every_n_layers == 0
    rope = rope_cos_sin(torch.from_numpy(pos.copy()), cfg.head_dim,
                        cfg.global_rope_theta if glob else cfg.local_rope_theta)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), bias_g if glob else bias_l, rope).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert layer.attn_norm.weight.shape == (cfg.hidden_size,)  # kept on layer 0 too, as in JAX


def test_encoder_matches_jax_with_windows_of_pads_only():
    cfg = jm.ModernBertTextConfig(**TEXT)
    x, mask = _layer_inputs(cfg, (13, 7, 2), 13, 4)  # rows 1-2: query windows (+-2) that hold only pads
    bias_g, bias_l = tm.modernbert_attention_biases(torch.from_numpy(mask), cfg.local_attention)
    idx = np.arange(13)
    want_local = np.where((mask[:, None, None, :] > 0) & (np.abs(idx[:, None] - idx[None]) <= 2)[None, None], 0.0,
                          np.finfo(np.float32).min)
    np.testing.assert_array_equal(bias_l.numpy(), want_local)
    assert (bias_l.numpy()[2, 0, :8] != 0).all()  # row 2's first 8 query rows see no valid key
    enc = jm.ModernBertEncoder(cfg)
    params = seeded(jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"], 5)
    want = np.asarray(jax.jit(enc.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    port = tm.ModernBertEncoder(tm.ModernBertTextConfig(**TEXT), device="cpu")
    port.load_state_dict({k.removeprefix("model.text_model."): v for k, v in state_dict_from_jax(
        {"model": {"text_model": params}}).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_encoder_matches_transformers_modernbert():
    """HF ModernBertModel (random weights, eager attention) over the same
    input embeddings: its ``embeddings.norm`` is the port's ``emb_norm``."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.ModernBertConfig(
        vocab_size=64, pad_token_id=0, bos_token_id=1, eos_token_id=2, cls_token_id=3, sep_token_id=4,
        hidden_size=32, intermediate_size=48, num_hidden_layers=4, num_attention_heads=4, global_attn_every_n_layers=3,
        local_attention=4, global_rope_theta=160000.0, local_rope_theta=10000.0, norm_eps=1e-5,
        attn_implementation="eager")
    hf = transformers.ModernBertModel(hf_cfg).eval().float()
    cfg = tm.ModernBertTextConfig.from_hf_config(hf_cfg.to_dict())
    port = tm.ModernBertEncoder(cfg, device="cpu")
    sd = hf.state_dict()
    state = {"emb_norm.weight": sd["embeddings.norm.weight"], "final_norm.weight": sd["final_norm.weight"]}
    for i in range(cfg.num_hidden_layers):
        for name, part in zip("qkv", sd[f"layers.{i}.attn.Wqkv.weight"].chunk(3)):
            state[f"layers.{i}.attn.{name}_proj.weight"] = part
        state[f"layers.{i}.attn.o_proj.weight"] = sd[f"layers.{i}.attn.Wo.weight"]
        state[f"layers.{i}.attn_norm.weight"] = sd.get(f"layers.{i}.attn_norm.weight", torch.ones(32))
        state[f"layers.{i}.mlp_norm.weight"] = sd[f"layers.{i}.mlp_norm.weight"]
        state[f"layers.{i}.Wi.weight"] = sd[f"layers.{i}.mlp.Wi.weight"]
        state[f"layers.{i}.Wo.weight"] = sd[f"layers.{i}.mlp.Wo.weight"]
    port.load_state_dict(state)
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(rng.normal(size=(2, 10, 32)).astype(np.float32))
    mask = torch.ones((2, 10), dtype=torch.int64)
    mask[1, -2:] = 0
    with torch.no_grad():
        want = hf(inputs_embeds=embeds, attention_mask=mask).last_hidden_state.numpy()
        got = port(embeds, mask).numpy()
    valid = mask.numpy().astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("mask_non_image", [False, True])
def test_colmodernvbert_pages_and_left_padded_queries_match_jax(loaded, mask_non_image):
    jax_model, variables, _, _, proc = loaded
    model = tm.ColModernVBert(proc_cfg := loaded[3].config, mask_non_image_embeddings=mask_non_image, device="cpu")
    model.load_state_dict(loaded[3].state_dict())
    japply = jax.jit(jm.ColModernVBert(jax_model.config, mask_non_image_embeddings=mask_non_image).apply)
    pages, queries = proc.process_images(_pages()), proc.process_queries(QUERIES)
    assert np.asarray(pages["tile_mask"]).sum(1).tolist() == [5, 3, 1]
    for batch in (pages, queries):
        mask = np.asarray(batch["attention_mask"])
        assert mask[:, -1].all() and not mask[:, 0].all()  # left padding
        want = np.asarray(japply(variables, **_jax(batch)))
        with torch.no_grad():
            got = model(**_torch(batch)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert np.isfinite(got).all()
    if mask_non_image:
        assert not got[np.asarray(queries["input_ids"]) == proc_cfg.image_token_id].any()


@pytest.mark.parametrize("strategy", ["cls", "last", "mean"])
def test_bimodernvbert_matches_jax(loaded, strategy):
    jax_model, variables, _, model, proc = loaded
    backbone = {"model": variables["params"]["model"]}
    japply = jax.jit(jm.BiModernVBert(jax_model.config, pooling_strategy=strategy).apply)
    bi = tm.BiModernVBert(model.config, pooling_strategy=strategy, device="cpu").eval()
    bi.load_state_dict({k: v for k, v in model.state_dict().items() if k.startswith("model.")})
    for batch in (proc.process_images(_pages()), proc.process_queries(QUERIES)):
        want = np.asarray(japply({"params": backbone}, **_jax(batch)))
        with torch.no_grad():
            got = bi(**_torch(batch)).numpy()
        assert got.shape == (len(want), TEXT["hidden_size"])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_masked_lm_matches_jax(loaded):
    jax_model, variables, _, model, proc = loaded
    batch = proc.process_images(_pages()[:2])
    jmlm = jm.ModernVBertForMaskedLM(jax_model.config)
    shapes = jax.eval_shape(jmlm.init, jax.random.PRNGKey(0), *_jax(batch).values())["params"]
    params = {**seeded({k: v for k, v in shapes.items() if k != "model"}, 6), "model": variables["params"]["model"]}
    want = np.asarray(jax.jit(jmlm.apply)({"params": params}, **_jax(batch)))
    mlm = tm.ModernVBertForMaskedLM(model.config, device="cpu").eval()
    mlm.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = mlm(**_torch(batch)).numpy()
    assert got.shape[-1] == TEXT["vocab_size"] + model.config.additional_vocab_size
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_query_encoder_bucket_and_a_query_alone_match_jax(loaded):
    jax_model, variables, jax_proc, model, proc = loaded
    encoder = QueryEncoder(model, proc)
    batched = encoder.encode(QUERIES)
    feed, _ = encoder._pad_static(proc.process_queries(QUERIES))
    assert feed["attention_mask"][:, -1].sum() == 0 and not feed["attention_mask"][:, 0].all()  # pads both sides
    want = JaxQueryEncoder(jax_model, variables, jax_proc).encode(QUERIES)
    for i, q in enumerate(QUERIES):
        np.testing.assert_allclose(batched[i], want[i], atol=ATOL, rtol=0)
        np.testing.assert_allclose(encoder.encode([q])[0], batched[i], atol=ATOL, rtol=0)


def test_processor_matches_jax(ckpt, loaded):
    jax_proc, proc = loaded[2], loaded[4]
    assert type(proc) is tpm.ColModernVBertProcessor and type(jax_proc) is jpm.ColModernVBertProcessor
    for device_pixels in (False, True):
        got, want = proc.process_images(_pages(), device_pixels=device_pixels), jax_proc.process_images(_pages())
        for key in ("input_ids", "attention_mask", "tile_mask"):
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
        np.testing.assert_allclose(np.asarray(got["pixel_values"]), np.asarray(want["pixel_values"]), atol=1e-4,
                                   rtol=0)
    ids = np.asarray(got["input_ids"])
    assert (ids[:, 0] == proc.tokenizer.pad_token_id).any() and (ids[:, -1] != proc.tokenizer.pad_token_id).all()
    assert proc.tokenizer.convert_ids_to_tokens(int(ids[0, 0])) == "<|begin_of_text|>"
    got, want = proc.process_queries(QUERIES), jax_proc.process_queries(QUERIES)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert proc._export_configs() == jax_proc._export_configs()
    bi = tpm.BiModernVBertProcessor.from_pretrained(ckpt, device="cpu")
    vecs = [np.eye(4, dtype=np.float32)[i] for i in range(3)]
    np.testing.assert_allclose(bi.score(vecs, vecs), np.eye(3), atol=1e-6)


def _cross_bit_for_bit(params, state, tmp_path):
    (tmp_path / "port").mkdir()
    safetensors.save_file(export_colmodernvbert_state_dict(state), str(tmp_path / "port" / "model.safetensors"))
    back = jax_load_params(str(tmp_path / "port"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    (tmp_path / "jax").mkdir()
    exported = jax_export(params)
    assert "model.text_model.layers.1.attn.Wqkv.weight" in exported
    assert "model.text_model.layers.0.attn_norm.weight" not in exported
    safetensors.save_file({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
                          str(tmp_path / "jax" / "model.safetensors"))
    assert set(safetensors.load_file(str(tmp_path / "jax" / "model.safetensors"))) == \
        set(export_colmodernvbert_state_dict(state))  # the same HF keys
    loaded = load_colmodernvbert_params(str(tmp_path / "jax"))
    assert set(loaded) == set(state)
    for key, value in loaded.items():
        assert torch.equal(value, state[key]), key


def test_hf_state_dicts_cross_bit_for_bit(loaded, tmp_path):
    jax_model, variables, _, model, _ = loaded
    got = model.state_dict()
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert torch.equal(got["model.text_model.layers.0.attn_norm.weight"], torch.ones(TEXT["hidden_size"]))
    _cross_bit_for_bit(variables["params"], got, tmp_path)
    bi = {"model": variables["params"]["model"]}  # BiModernVBert: no head parameters
    (tmp_path / "bi").mkdir()
    _cross_bit_for_bit(bi, {k: v for k, v in got.items() if k.startswith("model.")}, tmp_path / "bi")
    assert exporter_for(model.config) == exporter_for(jax_model.config) == "export_colmodernvbert_state_dict"
    save_pretrained(str(tmp_path / "export"), got, config=model.config)  # config.json: dataclasses.asdict
    cfg = json.loads((tmp_path / "export" / "config.json").read_text())
    cfg["_checkpoint_dir"] = str(tmp_path / "export")
    assert tm.ModernVBertConfig.from_hf_config(cfg) == model.config
    for key, value in load_colmodernvbert_params(str(tmp_path / "export")).items():
        assert torch.equal(value, got[key]), key


def test_load_retriever_and_serve_read_write_modernvbert_checkpoint_like_jax(loaded, tmp_path):
    cfg = loaded[3].config
    cfg = dataclasses.replace(cfg, additional_vocab_size=32)  # room for the grid markers of 4 x 4 tiles
    write_modernvbert_checkpoint(str(tmp_path), cfg, seed=4, words=" ".join(QUERIES).split(), device="cpu")
    assert "colmodernvbert" in _PORTED and set(_NOT_PORTED) == {"colqwen_omni"}
    assert detect_family({"architectures": ["ColModernVBert"]}) == "colmodernvbert"
    model, proc = load_retriever(str(tmp_path), dtype=torch.float32, device="cpu")
    assert type(model) is tm.ColModernVBert and model.config == cfg and proc.image_token_id == cfg.image_token_id
    assert (proc.tile_size, proc.longest_edge, proc.image_seq_len) == (32, 128, 4)
    jmodel, variables, jproc = jax_load_retriever(str(tmp_path), dtype=jnp.float32, param_dtype=jnp.float32)
    assert jmodel.config.text == jm.ModernBertTextConfig(**{**TEXT, "intermediate_size": 64})
    want_state = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert set(want_state) == set(model.state_dict())
    for key, value in want_state.items():
        assert torch.equal(model.state_dict()[key], value), key
    for batch, jbatch in ((proc.process_images(_pages()), jproc.process_images(_pages())),
                          (proc.process_queries(QUERIES), jproc.process_queries(QUERIES))):
        np.testing.assert_array_equal(batch["input_ids"], jbatch["input_ids"])
        want = np.asarray(jax.jit(jmodel.apply)(variables, **_jax(batch)))
        with torch.no_grad():
            got = model(**_torch(batch)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    docs = [e for e in QueryEncoder(model, proc).encode(QUERIES)]
    np.savez(tmp_path / "corpus.npz", **{f"emb_{i}": d for i, d in enumerate(docs)})
    httpd = serve.make_server([str(tmp_path / "corpus.npz"), "--device", "cpu", "--port", "0", "--checkpoint",
                               str(tmp_path), "--family", "colmodernvbert", "--no-quantize"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/search_text",
                                     data=json.dumps({"queries": QUERIES, "k": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert [row[0] for row in out["doc_ids"]] == [0, 1, 2]  # each query finds itself


# -- stored int8 -----------------------------------------------------------------------------------------------

WIDE_VISION = dict(hidden_size=512, intermediate_size=1024, num_hidden_layers=1, num_attention_heads=4,
                   image_size=32, patch_size=8)
WIDE_TEXT = dict(TEXT, hidden_size=512, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4)


def test_quantize_params_matches_jax_and_the_full_width_count():
    jcfg = jm.ModernVBertConfig(vision=JaxVisionConfig(**WIDE_VISION), text=jm.ModernBertTextConfig(**WIDE_TEXT),
                                pixel_shuffle_factor=2, additional_vocab_size=16, image_token_id=135)
    cfg = tm.ModernVBertConfig(vision=SiglipVisionConfig(**WIDE_VISION), text=tm.ModernBertTextConfig(**WIDE_TEXT),
                               pixel_shuffle_factor=2, additional_vocab_size=16, image_token_id=135)
    rng = np.random.default_rng(5)
    ids = rng.integers(2, 128, size=(2, 11)).astype(np.int32)
    ids[:, 3:7] = 135
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "pixel_values": rng.normal(size=(2, 1, 32, 32, 3)).astype(np.float32)}
    jmodel = jm.ColModernVBert(jcfg)
    params = seeded(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *_jax(batch).values())["params"], 6, 0.05)
    qp, qc = jqd.quantize_params(params)
    model = tm.ColModernVBert(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(model)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths) and len(paths) == 6 + 1 + 2 * 6  # the connector 2,048 -> 512
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    want_out = np.asarray(jax.jit(jmodel.apply)({"params": qp, "quant": qc}, *_jax(batch).values()))
    with torch.no_grad():
        got_out = model(*_torch(batch).values()).numpy()
    valid = mask.astype(bool)
    a, b = got_out[valid], want_out[valid]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.mean() >= QUANT_COS_MEAN and cos.min() >= QUANT_COS_MIN, (cos.mean(), cos.min())

    # ModernVBERT-base: JAX's quantize_params over the abstract tree, the port's over a model on "meta"
    full = jm.ModernVBertConfig()
    shapes = jax.eval_shape(jm.ColModernVBert(full).init, jax.random.PRNGKey(0), jnp.zeros((1, 80), jnp.int32),
                            jnp.ones((1, 80), jnp.int32), jnp.zeros((1, 1, 512, 512, 3), jnp.float32))["params"]
    full_qc = jax.eval_shape(lambda p: jqd.quantize_params(p)[1], shapes)
    full_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                  for path, _ in jax.tree_util.tree_flatten_with_path(full_qc)[0]]
    assert len(full_paths) == 12 * 6 + 1 + 22 * 6 == 205
    meta = tm.ColModernVBert(tm.ModernVBertConfig(), device="meta", dtype=torch.bfloat16)
    assert sorted(qd.quantize_params(meta)) == sorted(full_paths)
    assert sum(isinstance(m, QDense) and m.stored for m in meta.modules()) == 205
    assert dataclasses.asdict(tm.ModernVBertConfig()) == dataclasses.asdict(full)
