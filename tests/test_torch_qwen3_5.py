"""Port parity: ColQwen3_5 (Qwen3.5, the hybrid GatedDeltaNet / gated
attention decoder over Qwen3-VL's vision tower) in colpali_tpu_torch
against colpali_tpu, on the CPU, fp32, at the tiny widths of
``scripts/gate_families.py``'s ``make_synth_colqwen35`` (vision 2 x 32 over
14 px patches, a 4 x 4 position table; text 4 x 48 in one period, three
GatedDeltaNet layers (2/4 heads of 8, a conv of 2) and one gated attention
layer (GQA 4/2 x 16, rotary over 4 dims), 4 experts, top 2, on every
layer).

- Q2's plain version against JAX's ``chunk_gated_delta_rule`` at S = 1, 64
  and 150 (a padded last chunk, several chunks) with Hv/Hk = 2, at Dk = Dv
  = 128, and on a draw of about 2.0 log-decay per token (a chunk's decay
  passes 88: the exponent must be masked before ``exp``): rtol and atol
  1e-5, both finite; its gradient against ``jax.grad`` at 1e-4 (the
  backward sums in another order); Q2's plain backward (the backward
  kernel's reverse scan) against ``jax.vjp`` at 1e-4 over Hv/Hk = 1 and 2,
  S a multiple of 64 and not, S < 64, zeroed padding tokens and a decay of
  2.0 a token.
- At atol 2e-5, the checkpoint's JAX parameters moved by seeded noise and
  carried over by ``core/from_jax.py``: ``GatedDeltaNet`` (pad rows zeroed),
  ``GatedAttention``, ``SparseMoeBlock`` in both dispatch modes (capacity
  with dropped tokens), ColQwen3_5 on pages and queries; the decoder's raw
  hidden states over a left-padded batch at atol 5e-5 (``DECODER_ATOL``);
  the processor's integers exactly.
- Checkpoints: the MoE checkpoint read by the port bit for bit (experts
  stacked), the port's export equal to JAX's and read back by JAX's
  loader, JAX's scanned layout (``layers/layer/sub_{j}``, ``blocks/layer``)
  carried across; ``write_qwen35_checkpoint`` read by both packages'
  ``load_retriever``.
- Stored int8: ``quantize_params`` gives JAX's layers bit for bit, the
  forward by per-token cosine (mean >= 0.9999, min >= 0.999); the default
  config's tree by shapes alone (``jax.eval_shape``) against the port's on
  ``meta``, and the layers JAX quantizes there.
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
from colpali_tpu.core.hf_export import export_colqwen35_state_dict as jax_export  # noqa: E402
from colpali_tpu.core.hf_loader import group_hybrid_params, stack_layer_params  # noqa: E402
from colpali_tpu.core.hf_loader import load_colqwen35_params as jax_load_params  # noqa: E402
from colpali_tpu.models import qwen3_5 as jq  # noqa: E402
from colpali_tpu.models.layers import make_attention_bias  # noqa: E402
from colpali_tpu.models.qwen3_vl import interleaved_mrope_cos_sin as jax_mrope  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu_torch.auto import _NOT_PORTED, _PORTED, detect_family, exporter_for, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colqwen35_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colqwen35_params  # noqa: E402
from colpali_tpu_torch.models import qwen3_5 as tq  # noqa: E402
from colpali_tpu_torch.models.gemma3 import gemma3_attention_bias  # noqa: E402
from colpali_tpu_torch.models.qwen3_vl import interleaved_mrope_cos_sin  # noqa: E402
from colpali_tpu_torch.ops import gated_delta_rule as gdr  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.processors.qwen3_vl import ColQwen3_5Processor  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402
from colpali_tpu_torch.utils.testing import write_qwen35_checkpoint  # noqa: E402

ATOL = 2e-5
# the decoder's raw hidden states (RMS ~2.5, up to ~7): each GatedDeltaNet head's output is divided by its own RMS
# (the gated RMSNorm), which in heads of small RMS (down to 3e-4 here) turns the packages' ~1e-6 fp32 rounding of the
# projections and the delta rule into up to 2.3e-5 of the head's scale; 3.1e-5 was read after 4 layers
DECODER_ATOL = 5e-5
QUANT_COS_MEAN, QUANT_COS_MIN = 0.9999, 0.999  # test_torch_qwen2_5_vl.py's rule for a stored-int8 forward
QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?", "a"]
PAGE_SHAPES = ((112, 84), (56, 112), (30, 40))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import gate_families as gf

    path = tmp_path_factory.mktemp("synth") / "colqwen3_5-tiny"
    init = jq.ColQwen3_5.init
    jq.ColQwen3_5.init = lambda self, rng, **kw: jax.jit(lambda r, k: init(self, r, **k))(rng, kw)
    try:
        gf.make_synth_colqwen35(str(path))
    finally:
        jq.ColQwen3_5.init = init
    return str(path)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(JAX model, its variables with every leaf moved by seeded noise, JAX
    processor, the port's ColQwen3_5 holding the same weights, its processor)."""
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


def _delta_inputs(seed, b, s, hk, hv, dk, dv, log_decay):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, hk, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, s, hv, dv)).astype(np.float32)
    g = (-log_decay * rng.uniform(0.5, 1.5, size=(b, s, hv))).astype(np.float32)
    beta = rng.uniform(0.0, 1.0, size=(b, s, hv)).astype(np.float32)
    return q, k, v, g, beta


@pytest.mark.parametrize("s,hk,hv,dk,dv,log_decay", [(1, 2, 4, 8, 8, 0.1), (64, 2, 4, 8, 8, 0.1),
                                                      (150, 2, 4, 8, 8, 0.1), (150, 2, 4, 8, 8, 2.0),
                                                      (70, 1, 2, 128, 128, 0.1)])
def test_chunk_gated_delta_rule_plain_matches_jax(s, hk, hv, dk, dv, log_decay):
    q, k, v, g, beta = _delta_inputs(s + hk, 2, s, hk, hv, dk, dv, log_decay)
    rep = hv // hk
    want = np.asarray(jq.chunk_gated_delta_rule(jnp.repeat(q, rep, axis=2), jnp.repeat(k, rep, axis=2), v, g, beta))
    got = gdr.chunk_gated_delta_rule(*map(torch.from_numpy, (q, k, v, g, beta)))
    assert got.shape == (2, s, hv, dv) and got.dtype == torch.float32
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if log_decay > 1:  # a chunk's cumulative decay passes 88, where an unmasked exp overflows
        assert -g[0, :64, 0].sum() > 88


def test_chunk_gated_delta_rule_plain_gradient_matches_jax():
    q, k, v, g, beta = _delta_inputs(5, 1, 90, 2, 4, 8, 8, 0.5)
    w = np.random.default_rng(6).normal(size=(1, 90, 4, 8)).astype(np.float32)

    def jax_loss(*args):
        qq, kk = (jnp.repeat(x, 2, axis=2) for x in args[:2])
        return jnp.sum(jq.chunk_gated_delta_rule(qq, kk, *args[2:]) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(q, k, v, g, beta)
    inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, g, beta)]
    (gdr.chunk_gated_delta_rule(*inputs) * torch.from_numpy(w)).sum().backward()
    for t, want_grad in zip(inputs, want):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,hk,hv,dk,dv,log_decay,zeroed", [
    (2, 64, 2, 2, 8, 8, 0.1, False),  # Hv/Hk = 1, S a multiple of 64
    (2, 150, 2, 4, 8, 16, 0.5, True),  # Hv/Hk = 2, a padded last chunk, zeroed padding tokens
    (3, 37, 1, 2, 16, 8, 0.3, False),  # S < 64: one partial chunk, as a query's
    (1, 150, 2, 4, 8, 8, 2.0, True),  # a chunk's decay past 88: every exponent masked before exp
    (1, 70, 1, 2, 128, 128, 0.1, False)])  # Qwen3.5's head dims
def test_chunk_gated_delta_rule_backward_plain_matches_jax_vjp(b, s, hk, hv, dk, dv, log_decay, zeroed):
    """The plain backward (the kernel's reverse scan, not autograd) against ``jax.vjp`` of JAX's
    ``chunk_gated_delta_rule`` (key heads repeated inside the function) with a seeded cotangent, at the existing
    gradient test's 1e-4; finite everywhere. Zeroed tokens (``x * attention_mask`` before the projections) have
    ``l2norm(0) = 0`` and a gradient of ``rsqrt(eps)`` times theirs."""
    q, k, v, g, beta = _delta_inputs(s + dk + hv, b, s, hk, hv, dk, dv, log_decay)
    if zeroed:
        q[0, :9], k[0, :9] = 0.0, 0.0  # left padding of the first row
    d_out = np.random.default_rng(s + 1).normal(size=(b, s, hv, dv)).astype(np.float32)
    rep = hv // hk

    def forward(qq, kk, vv, gg, bb):
        return jq.chunk_gated_delta_rule(jnp.repeat(qq, rep, axis=2), jnp.repeat(kk, rep, axis=2), vv, gg, bb)

    want = jax.jit(lambda *a: jax.vjp(forward, *a[:5])[1](a[5]))(*map(jnp.asarray, (q, k, v, g, beta, d_out)))
    got = gdr.chunk_gated_delta_rule_backward_plain(*map(torch.from_numpy, (q, k, v, g, beta, d_out)))
    for name, x, w in zip(("dq", "dk", "dv", "dg", "dbeta"), got, want):
        w = np.asarray(w)
        assert x.shape == w.shape and x.dtype == torch.float32, name
        assert np.isfinite(w).all() and torch.isfinite(x).all(), name
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)
    if log_decay > 1:
        assert -g[0, :64, 0].sum() > 88


def test_processor_integers_match_jax(loaded):
    jax_proc, proc = loaded[2], loaded[4]
    assert type(proc) is ColQwen3_5Processor and proc.num_grid_per_side == jax_proc.num_grid_per_side == 4
    want = jax_proc.process_images(_pages())
    got = proc.process_images(_pages())
    assert set(got) == set(want)
    for key in ("input_ids", "attention_mask", "patch_mask", "vision_hpos", "vision_wpos", "position_ids",
                "image_grid_thw", "pos_idx", "pos_weight"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and np.array_equal(g, w), key
    np.testing.assert_allclose(np.asarray(got["pixel_values"]), want["pixel_values"], atol=1e-4, rtol=0)
    q, jq_ = proc.process_queries(QUERIES), jax_proc.process_queries(QUERIES)
    for key in ("input_ids", "attention_mask"):
        assert np.array_equal(np.asarray(q[key]), np.asarray(jq_[key]))


def _layer_inputs(cfg, seed=7):
    """Hidden states of a left-padded batch of 3 rows x 70 tokens (two
    chunks of the delta rule), its mask and the rotary tables."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 70, cfg.hidden_size)).astype(np.float32)
    mask = (np.arange(70)[None] >= np.array([[0], [9], [65]])).astype(np.int32)
    pos = np.broadcast_to(np.clip(np.cumsum(mask, -1) - 1, 0, None)[None], (3, 3, 70)).copy()
    return x, mask, pos


def test_gated_delta_net_matches_jax(loaded):
    jax_model, variables, _, model, _ = loaded
    cfg = jax_model.config.text
    assert cfg.layer_type(0) == "linear_attention" and cfg.linear_conv_kernel_dim == 2
    x, mask, _ = _layer_inputs(cfg)
    want = np.asarray(jax.jit(jq.GatedDeltaNet(cfg).apply)(
        {"params": variables["params"]["model"]["language_model"]["layers_0"]["linear_attn"]}, jnp.asarray(x),
        jnp.asarray(mask)))
    layer = model.model.language_model.layers[0].linear_attn
    assert layer.A_log.dtype == layer.dt_bias.dtype == torch.float32
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not got[2, :65].any()  # pad rows: zeroed before the projections, the gate silu(0) = 0


def test_gated_attention_matches_jax(loaded):
    jax_model, variables, _, model, _ = loaded
    cfg = jax_model.config.text
    assert cfg.layer_type(3) == "full_attention" and cfg.rotary_dim == 4
    x, mask, pos = _layer_inputs(cfg)
    rope = jax_mrope(jnp.asarray(pos), cfg.rotary_dim, cfg.rope_theta, (cfg.rotary_dim // 2, 0, 0))
    want = np.asarray(jax.jit(jq.GatedAttention(cfg).apply)(
        {"params": variables["params"]["model"]["language_model"]["layers_3"]["self_attn"]}, jnp.asarray(x),
        make_attention_bias(jnp.asarray(mask), causal=True), rope))
    rope_t = interleaved_mrope_cos_sin(torch.from_numpy(pos), 4, cfg.rope_theta, (2, 0, 0))
    with torch.no_grad():
        got = model.model.language_model.layers[3].self_attn(
            torch.from_numpy(x), gemma3_attention_bias(torch.from_numpy(mask), None, None), rope_t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)  # pad rows too: JAX's even spread over the keys


@pytest.mark.parametrize("capacity_factor", [0.0, 0.6])
def test_sparse_moe_block_matches_jax_in_both_dispatch_modes(loaded, capacity_factor):
    jax_model, variables, _, model, _ = loaded
    cfg = dataclasses.replace(jax_model.config.text, moe_capacity_factor=capacity_factor)
    x = np.random.default_rng(9).normal(size=(2, 37, cfg.hidden_size)).astype(np.float32)
    mlp_params = {"params": variables["params"]["model"]["language_model"]["layers_1"]["mlp"]}
    want = np.asarray(jax.jit(jq.SparseMoeBlock(cfg).apply)(mlp_params, jnp.asarray(x)))
    block = tq.SparseMoeBlock(tq.Qwen35TextConfig(**dataclasses.asdict(cfg)), device="cpu")
    block.load_state_dict(model.model.language_model.layers[1].mlp.state_dict())
    assert block.experts.gate_proj.shape == (4, 48, 32)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if capacity_factor:  # 74 tokens x 2 choices over 4 experts of 23 slots: tokens are dropped
        dense = tq.SparseMoeBlock(tq.Qwen35TextConfig(**{**dataclasses.asdict(cfg), "moe_capacity_factor": 0.0}),
                                  device="cpu")
        dense.load_state_dict(block.state_dict())
        with torch.no_grad():
            assert np.abs(dense(torch.from_numpy(x)).numpy() - got).max() > 1e-3


def test_decoder_matches_jax_on_a_left_padded_batch(loaded):
    jax_model, variables, _, model, _ = loaded
    cfg = jax_model.config.text
    x, mask, pos = _layer_inputs(cfg, seed=8)
    want = np.asarray(jax.jit(jq.HybridDecoder(cfg).apply)(
        {"params": variables["params"]["model"]["language_model"]}, jnp.asarray(x),
        make_attention_bias(jnp.asarray(mask), causal=True), jnp.asarray(pos), jnp.asarray(mask)))
    with torch.no_grad():
        got = model.model.language_model(torch.from_numpy(x), gemma3_attention_bias(torch.from_numpy(mask), None, None),
                                         torch.from_numpy(pos), torch.from_numpy(mask)).numpy()
    rows = mask.astype(bool)
    np.testing.assert_allclose(got[rows], want[rows], atol=DECODER_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["pages", "queries"])
def test_colqwen3_5_matches_jax(loaded, kind):
    jax_model, variables, _, model, proc = loaded
    batch = proc.process_queries(QUERIES) if kind == "queries" else proc.process_images(_pages())
    want = np.asarray(jax.jit(jax_model.apply)(variables, **_jax(batch)))
    with torch.no_grad():
        got = model(**_torch(batch)).numpy()
    assert got.shape == want.shape and got.shape[-1] == 128 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kind == "pages":  # the deepstack mergers are loaded, not used: moving them changes nothing
        state = {k: v + 1.0 if "deepstack" in k else v for k, v in model.state_dict().items()}
        moved = tq.ColQwen3_5(model.config, device="cpu").eval()
        moved.load_state_dict(state)
        with torch.no_grad():
            assert torch.equal(moved(**_torch(batch)), torch.from_numpy(got))


def test_checkpoints_cross_load_bit_for_bit(ckpt, tmp_path):
    _, variables, _ = jax_load_retriever(ckpt, dtype=jnp.float32, param_dtype=jnp.float32)
    model, _ = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    state = model.state_dict()
    assert set(state) == set(want) and state["model.language_model.layers.2.mlp.experts.down_proj"].shape == (4, 32, 48)
    assert state["model.language_model.layers.0.linear_attn.conv1d_kernel"].shape == (2, 2 * 16 + 32)
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    ours = export_colqwen35_state_dict(state, patch_size=14)
    theirs = jax_export(jax.tree.map(np.asarray, variables["params"]), patch_size=14)
    assert set(ours) == set(theirs) and "model.language_model.layers.1.mlp.experts.3.up_proj.weight" in ours
    assert ours["model.language_model.layers.0.linear_attn.conv1d.weight"].shape == (64, 1, 2)
    for key, value in theirs.items():
        assert np.array_equal(ours[key].numpy(), np.asarray(value)), key
    assert exporter_for(model.config) == "export_colqwen35_state_dict"
    save_pretrained(str(tmp_path), state, config=model.config)  # the training export: exporter by the config
    back = state_dict_from_jax(jax.tree.map(np.asarray, jax_load_params(str(tmp_path))))
    assert set(back) == set(state) and all(torch.equal(back[k], v) for k, v in state.items())
    assert tq.Qwen35VLConfig.from_hf_config(json.loads((tmp_path / "config.json").read_text())) == model.config
    safetensors.save_file({k: np.asarray(v) for k, v in theirs.items()}, str(tmp_path / "model.safetensors"))
    again = load_colqwen35_params(str(tmp_path))
    assert all(torch.equal(again[k], v) for k, v in state.items())


def test_scanned_jax_layout_is_carried_across(loaded):
    params = loaded[1]["params"]
    interval = loaded[0].config.text.full_attention_interval
    scanned = stack_layer_params(group_hybrid_params(params, interval), stack_names=("blocks",))
    lm = scanned["model"]["language_model"]
    assert "layers_0" not in lm and set(lm["layers"]["layer"]) == {f"sub_{j}" for j in range(interval)}
    assert "blocks" in scanned["model"]["visual"]
    want = state_dict_from_jax(params)
    got = state_dict_from_jax(jax.tree.map(np.asarray, scanned))
    assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())


def test_load_retriever_registry_row_and_written_checkpoint_match_jax(loaded, tmp_path):
    assert "colqwen3_5" in _PORTED and set(_NOT_PORTED) == {"colqwen_omni"}
    for cfg in ({"model_type": "qwen3_5"}, {"model_type": "qwen3_5_vl"}, {"architectures": ["ColQwen3_5"]}):
        assert detect_family(cfg) == jax_detect_family(cfg) == "colqwen3_5"
    tiny = loaded[3].config  # at Qwen's vocabulary and special ids, which the word-level tokenizer writes
    config = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, vocab_size=151936), image_token_id=151655,
                                 vision_start_token_id=151652)
    write_qwen35_checkpoint(str(tmp_path), config, seed=4, words=" ".join(QUERIES).split(), device="cpu")
    model, proc = load_retriever(str(tmp_path), family="colqwen3_5", dtype=torch.float32, device="cpu")
    assert type(model) is tq.ColQwen3_5 and model.config == config and proc.max_pixels == 768 * 28 * 28
    linear = model.model.language_model.layers[0].linear_attn
    assert linear.A_log.std() > 0.1 and linear.conv1d_kernel.abs().max() <= 2**-0.5  # HF's draws, not the defaults
    jmodel, variables, jproc = jax_load_retriever(str(tmp_path), dtype=jnp.float32, param_dtype=jnp.float32)
    for batch in (proc.process_images(_pages()[:2]), proc.process_queries(QUERIES)):
        want = np.asarray(jax.jit(jmodel.apply)(variables, **_jax(batch)))
        with torch.no_grad():
            got = model(**_torch(batch)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_quantize_params_matches_jax_and_the_full_width_tree(loaded):
    jax_model, variables, _, model, proc = loaded
    params = variables["params"]
    qp, qc = jqd.quantize_params(params, min_dim=32)
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    qmodel = tq.ColQwen3_5(model.config, device="cpu").eval()
    qmodel.load_state_dict(state_dict_from_jax(params))
    paths = qd.quantize_params(qmodel, min_dim=32)
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths) and "model/language_model/layers_0/linear_attn/in_proj_qkvz/kernel" in paths
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

    # the default config by shapes alone: JAX's tree under eval_shape, the port's model on "meta". Its tower's merger
    # writes Qwen3-VL-4B's 2,560 wide, its decoder takes 2,048: a page forward runs with the merger's output at the
    # decoder's width, as chip_smoke.py's phase 19 builds it (and Qwen3.5's checkpoints are)
    default = jq.Qwen35VLConfig()
    assert (default.vision.out_hidden_size, default.text.hidden_size) == (2560, 2048)
    full = dataclasses.replace(default, vision=dataclasses.replace(default.vision, out_hidden_size=2048))
    p, s = 16, 12
    shapes = jax.eval_shape(jq.ColQwen3_5(full).init, jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
                            jnp.ones((1, s), jnp.int32), jnp.zeros((1, p, full.vision.patch_dim), jnp.float32),
                            vision_hpos=jnp.zeros((1, p), jnp.int32), vision_wpos=jnp.zeros((1, p), jnp.int32),
                            patch_mask=jnp.ones((1, p), bool), pos_idx=jnp.zeros((1, p, 4), jnp.int32),
                            pos_weight=jnp.zeros((1, p, 4), jnp.float32))["params"]
    flat = {"/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port_default = tq.Qwen35VLConfig()
    meta = tq.ColQwen3_5(dataclasses.replace(port_default, vision=dataclasses.replace(port_default.vision,
                                                                                      out_hidden_size=2048)),
                         device="meta", dtype=torch.bfloat16)
    port_shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    want_shapes = {_port_name(path): tuple(reversed(shape)) if path.endswith("/kernel") else tuple(shape)
                   for path, shape in flat.items()}
    assert want_shapes == port_shapes
    n_params = sum(int(np.prod(s)) for s in flat.values())
    assert n_params == sum(v.numel() for v in meta.parameters()) and 3.8e9 < n_params < 4.0e9
    full_qc = jax.eval_shape(lambda x: jqd.quantize_params(x)[1], shapes)
    full_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                  for path, _ in jax.tree_util.tree_flatten_with_path(full_qc)[0]]
    assert sorted(qd.quantize_params(meta)) == sorted(full_paths)
    # the tower's 1 + 27 x 6 + 2 x 4; a GatedDeltaNet layer's in_proj_qkvz and out_proj, an attention layer's
    # q/o (k/v 2,048 -> 512 too), every layer's gate/up/down
    assert len(full_paths) == 1 + 27 * 6 + 2 * 4 + 36 * (2 + 3) + 12 * (4 + 3)
    assert dataclasses.asdict(port_default) == dataclasses.asdict(default)


def _port_name(path: str) -> str:
    """A JAX parameter path's name in the port (``core/from_jax.py``'s rule)."""
    *parts, last = path.split("/")
    last = "weight" if last in ("kernel", "embedding", "scale") else last
    return ".".join(re.sub(r"^(layers|blocks)_(\d+)$", r"\1.\2", p) for p in (*parts, last))
