"""Port parity: stored-int8 and dynamic w8a8 weights (colpali_tpu_torch
against colpali_tpu.ops.quant_dense and QDense), on the CPU where the
kernels Q1a and Q1b run their plain versions.

Single ops are held bit for bit: the row and column quantizers (JAX's
arithmetic under ``jit``, where XLA multiplies by fp32(1/127), and eagerly,
where it divides), ``stored_int8_apply`` and ``int8_linear`` through JAX's
``QDense`` (int32 sums are exact; the epilogue rounds in the same order),
``quantize_params`` and ``dequantize_params``. Whole models are held by
per-token cosine: quantized activations are discontinuous, and fp32
products summed in another order by XLA and PyTorch can move an activation
across an int8 rounding boundary (none did here). The carried ``(qp, qc)``
forward of the tiny ColPali is held at per-token cosine >= 1 - 1e-6 and max
abs 1e-6 (measured 1 - 1.2e-7 and 6.0e-8, pages and queries), and
``load_retriever(quantize=True)`` on the 512-wide checkpoint at cosine >=
1 - 1e-6 and max abs 5e-6 (measured 1 - 1.2e-7 and 2.8e-7): about 10x and
20x the fp32 rounding seen, far below one int8 step of an activation.
"""

import json
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from __graft_entry__ import _example_batch, _tiny_colpali  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.models.layers import QDense as JaxQDense  # noqa: E402
from colpali_tpu.models.layers import quantized_acts as jax_quantized_acts  # noqa: E402
from colpali_tpu.ops import quant_dense as jqd  # noqa: E402
from colpali_tpu_torch.auto import load_retriever  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colpali_state_dict  # noqa: E402
from colpali_tpu_torch.models import layers as tl  # noqa: E402
from colpali_tpu_torch.models.common import hf_init_  # noqa: E402
from colpali_tpu_torch.models.paligemma import ColPali  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402
from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec  # noqa: E402
from test_torch_colpali import port_config  # noqa: E402

FORWARD_COS, FORWARD_ATOL = 1 - 1e-6, 1e-6
CKPT_COS, CKPT_ATOL = 1 - 1e-6, 5e-6


def _jax(x: np.ndarray, dtype) -> jnp.ndarray:
    return jnp.asarray(x, jnp.float32).astype(dtype)


def _torch(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _rows(rng, m: int, k: int) -> np.ndarray:
    """Gaussian rows, a zero row, and rows built on exact .5 ties under both
    scale arithmetics (eager: absmax 254 gives scale 2; jit: multiples of
    the scale fp32(254 * fp32(1/127)))."""
    x = rng.normal(size=(m, k)).astype(np.float32) * 3
    x[1] = 0.0
    ties = np.arange(k, dtype=np.float32) % 21 - 10.0 + 0.5
    x[2] = ties * 2
    x[2, 0] = 254.0
    s_jit = np.float32(254.0) * np.float32(np.float32(1) / np.float32(127))
    x[3] = (ties * s_jit).astype(np.float32)
    x[3, 0] = 127.0 * s_jit
    return x


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(6, 40), (2, 5, 64)])
@pytest.mark.parametrize("jit", [True, False])
def test_quantize_rows_and_cols_bit_exact_against_jax(dtype, shape, jit):
    rng = np.random.default_rng(sum(shape))
    x = _rows(rng, int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jrows = jax.jit(jqd._quantize_rows) if jit else jqd._quantize_rows
    port_rows = qd.quantize_rows if jit else qd.quantize_rows_eager
    q, s = port_rows(_torch(x, tdt))
    jq, js = jrows(_jax(x, jdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (*shape[:-1], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q.reshape(-1, shape[-1])[1] == 0).all() and s.reshape(-1)[1] == 1.0  # the zero row

    w = x.reshape(-1, shape[-1]).T  # a (K, N) JAX-layout weight
    jcols = jax.jit(jqd._quantize_cols) if jit else jqd._quantize_cols
    if jit:
        qc, sc = qd.quantize_cols(_torch(w, tdt))
    else:  # JAX's eager arithmetic: quantize_params' rows of the (N, K) weight
        qc, sc = (t.mT for t in qd.quantize_rows_eager(_torch(w.T, tdt)))
    jqc, jsc = jcols(_jax(w, jdt))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_scale_arithmetics_differ_where_jax_does():
    """The two arithmetics are not the same function: jit's multiply by
    fp32(1/127) and the eager divide give other scales on some rows, and
    each port path follows its JAX path there."""
    a = np.abs(np.random.default_rng(0).normal(size=(4096, 1)).astype(np.float32)) * 5
    jit_s = np.asarray(jax.jit(jqd._quantize_rows)(jnp.asarray(a))[1])
    eager_s = np.asarray(jqd._quantize_rows(jnp.asarray(a))[1])
    assert (jit_s != eager_s).any()
    np.testing.assert_array_equal(qd.quantize_rows(torch.from_numpy(a))[1].numpy(), jit_s)
    np.testing.assert_array_equal(qd.quantize_rows_eager(torch.from_numpy(a))[1].numpy(), eager_s)


def _jax_qdense(x, params, quant, dtype, dynamic: bool):
    mod = JaxQDense(params["kernel"].shape[1], use_bias="bias" in params, dtype=dtype, param_dtype=dtype)
    variables = {"params": params, **({"quant": quant} if quant is not None else {})}

    def fwd(v, x):
        return mod.apply(v, x)

    if dynamic:
        with jax_quantized_acts():
            return np.asarray(jax.jit(fwd)(variables, x).astype(jnp.float32))
    return np.asarray(jax.jit(fwd)(variables, x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", [False, True])
@torch.no_grad()
def test_stored_int8_apply_and_int8_linear_bit_exact_through_jax_qdense(dtype, bias):
    rng = np.random.default_rng(11 + bias)
    k, n = 512, 640
    x = (rng.normal(size=(2, 7, k)) * 2).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)  # JAX layout (K, N)
    b = (rng.normal(size=(n,)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jw = _jax(w, jdt)
    params = {"kernel": jw, **({"bias": _jax(b, jdt)} if bias else {})}

    layer = tl.QDense(k, n, bias=bias, device="cpu", dtype=tdt)
    layer.weight.copy_(_torch(w.T, tdt))
    if bias:
        layer.bias.copy_(_torch(b, tdt))
    xt, xj = _torch(x, tdt), _jax(x, jdt)

    # dynamic w8a8: weights quantized on the call
    with tl.quantized_acts():
        got = layer(xt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _jax_qdense(xj, params, None, jdt, dynamic=True))
    exact = layer(xt)
    assert not torch.equal(exact, got)  # outside the context: the exact product

    # stored int8: the kernel quantized once, as quantize_params does
    qp, qc = jqd.quantize_params({"d": params}, min_dim=512)
    want = _jax_qdense(xj, qp["d"], qc["d"], jdt, dynamic=False)
    q, s = qd.quantize_rows_eager(_torch(w.T, tdt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp["d"]["kernel"]).T)
    layer.store_int8(q, s.reshape(-1))
    got = layer(xt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    direct = qd.stored_int8_apply(xt, q, s.reshape(-1), tdt, layer.bias)
    assert torch.equal(direct, got)


def test_int8_gemm_plain_sums_exactly_at_the_largest_k():
    """fp64 sums of int8 products are exact: at K = 16,384 with every
    product 127^2 the plain version gives the int32 sum's fp32 value."""
    k = 16384
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((3, k), 127, dtype=torch.int8)
    out = qd.int8_gemm_plain(a, torch.ones(2, 1), b, torch.ones(3), out_dtype=torch.float32)
    want = np.float32(np.int64(k) * 127 * 127)  # 264,257,536: above 2^24, rounded once
    assert out[0, 0].item() == want and out[1, 2].item() == -want


@pytest.mark.parametrize("sign", [1, -1])
def test_fma_f32_rounds_once(sign):
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on a midpoint between two fp32
    values; a tiny c decides the rounding of the exact sum, which an fp64
    sum rounded again to fp32 loses (it lands on the midpoint and ties to
    even). Random triples agree with fp64 wherever that is exact."""
    a = torch.tensor([1 + 2.0**-12], dtype=torch.float32)
    c = torch.tensor([sign * 2.0**-60], dtype=torch.float32)
    low, high = np.float32(1 + 2.0**-11), np.nextafter(np.float32(1 + 2.0**-11), np.float32(2))
    assert (a.double() * a.double() + c.double()).float().item() == low  # the double rounding
    assert qd.fma_f32(a, a, c).item() == (high if sign > 0 else low)
    rng = np.random.default_rng(0)
    x, y, z = (torch.from_numpy(rng.normal(size=10_000).astype(np.float32)) for _ in range(3))
    assert torch.equal(qd.fma_f32(x, y, z), (x.double() * y.double() + z.double()).float())


DN = (((1,), (0,)), ((), ()))


@pytest.mark.parametrize("case", ["small_contraction", "small_output", "integer", "batched", "threshold"])
def test_int8_linear_falls_through_where_jax_does(case):
    """JAX's shape self-gating (tests/ops/test_quant_dense.py:77-113): an
    ineligible product is the exact one bit for bit, an eligible one is
    quantized, and the port decides as JAX does."""
    rng = np.random.default_rng(4)
    f32 = np.float32
    if case == "small_contraction":
        x, w = rng.normal(size=(16, 128)).astype(f32), rng.normal(size=(128, 1024)).astype(f32)
    elif case == "small_output":
        x, w = rng.normal(size=(16, 2048)).astype(f32), rng.normal(size=(2048, 128)).astype(f32)
    elif case == "integer":
        x, w = rng.integers(-5, 5, (8, 512)).astype(np.int8), rng.integers(-5, 5, (512, 512)).astype(np.int8)
    elif case == "batched":
        x, w = rng.normal(size=(2, 16, 512)).astype(f32), rng.normal(size=(2, 512, 512)).astype(f32)
    else:
        x, w = rng.normal(size=(4, 512)).astype(f32), rng.normal(size=(512, 511)).astype(f32)
    wt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2)))
    got = qd.int8_linear(torch.from_numpy(x), wt)
    assert torch.equal(got, torch.matmul(torch.from_numpy(x), wt.transpose(-1, -2)))
    if case == "batched":
        dn = (((2,), (1,)), ((0,), (0,)))
        jgot, jexact = jqd.int8_dot_general(jnp.asarray(x), jnp.asarray(w), dn), jax.lax.dot_general(
            jnp.asarray(x), jnp.asarray(w), dn)
    else:
        jgot = jqd.int8_dot_general(jnp.asarray(x), jnp.asarray(w), DN)
        jexact = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), DN)
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(jexact))
    if case == "threshold":  # exactly MIN_QUANT_DIM is eligible, in both packages
        w_ok = rng.normal(size=(512, 512)).astype(f32)
        got = qd.int8_linear(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w_ok.T)))
        jgot = jqd.int8_dot_general(jnp.asarray(x), jnp.asarray(w_ok), DN, preferred_element_type=jnp.float32)
        assert not np.array_equal(np.asarray(jgot), np.asarray(x @ w_ok))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(
            lambda a, b: jqd.int8_dot_general(a, b, DN))(jnp.asarray(x), jnp.asarray(w_ok))))


def test_quantization_error_matches_jax():
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=(64, 1024)).astype(np.float32), rng.normal(size=(1024, 1024)).astype(np.float32)
    got = qd.quantization_error(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)))
    assert 0 < got < 0.02
    assert got == pytest.approx(jqd.quantization_error(jnp.asarray(x), jnp.asarray(w)), rel=1e-4)


# -- the model ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jax_model, jax_cfg = _tiny_colpali(jnp.float32)
    ids, mask, pixels = _example_batch(jax_cfg)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(pixels))
    params = jax.tree.map(np.asarray, variables["params"])
    return jax_model, jax_cfg, params, (ids, mask, pixels)


def _port_model(tiny, params) -> ColPali:
    jax_model, jax_cfg = tiny[0], tiny[1]
    model = ColPali(port_config(jax_cfg), dim=jax_model.dim, device="cpu",
                    dtype=torch.bfloat16 if np.asarray(params["head"]["custom_text_proj"]["kernel"]).dtype.name ==
                    "bfloat16" else torch.float32)
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


FILTERS = {"all": (16, None), "by_shape": (33, None),
           "vision_only": (16, lambda p: p.startswith("model/vision_tower/"))}


@pytest.mark.parametrize("which", list(FILTERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_gives_jax_bytes(tiny, which, dtype):
    min_dim, path_filter = FILTERS[which]
    params = tiny[2] if dtype == "float32" else jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                                              tiny[2])
    qp, qc = jqd.quantize_params(params, min_dim=min_dim, path_filter=path_filter)
    want = state_dict_from_jax(jax.tree.map(np.asarray, qp), jax.tree.map(np.asarray, qc))
    model = _port_model(tiny, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    paths = qd.quantize_params(model, min_dim=min_dim, path_filter=path_filter)
    got = model.state_dict()
    jax_paths = ["/".join(str(k.key) for k in path[:-1]) + "/kernel"
                 for path, _ in jax.tree_util.tree_flatten_with_path(qc)[0]]
    assert sorted(paths) == sorted(jax_paths) and paths
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    assert torch.equal(got["model.vision_tower.patch_embedding.weight"],
                       before["model.vision_tower.patch_embedding.weight"])  # a Conv kernel in JAX
    head_int8 = got["head.custom_text_proj.weight"].dtype == torch.int8
    assert head_int8 == (which == "all")  # the 64 -> 32 head: quantized by shape at min_dim 16 only
    if which == "by_shape":  # Gemma's k/v (64 -> 16) and the head stay exact, as at ColPali-3B's widths
        assert got["model.language_model.layers.0.self_attn.k_proj.weight"].dtype == before[
            "model.language_model.layers.0.self_attn.k_proj.weight"].dtype
        assert got["model.language_model.layers.0.self_attn.q_proj.weight"].dtype == torch.int8
    if which == "vision_only":
        assert all(p.startswith("model/vision_tower/") for p in paths)
        assert got["model.multi_modal_projector.weight"].dtype != torch.int8

    back = jqd.dequantize_params(qp, qc, dtype=jnp.float32)
    qd.dequantize_params(model, dtype=torch.float32)
    for key, value in state_dict_from_jax(jax.tree.map(np.asarray, back)).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_carried_quantized_tree_forward_matches_jax(tiny):
    """JAX's ``(qp, qc)`` carried across and run by the port against
    ``model.apply({"params": qp, "quant": qc})``, pages and queries."""
    jax_model, jax_cfg, params, (ids, mask, pixels) = tiny
    qp, qc = jqd.quantize_params(params, min_dim=16)
    model = ColPali(port_config(jax_cfg), dim=jax_model.dim, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax({"params": jax.tree.map(np.asarray, qp),
                                                       "quant": jax.tree.map(np.asarray, qc)}))
    assert model.model.language_model.layers[1].mlp.down_proj.stored
    variables = {"params": qp, "quant": qc}
    for batch in ((ids, mask, pixels), (ids[:, 16:], mask[:, 16:], None)):
        want = np.asarray(jax.jit(jax_model.apply)(variables, *[None if b is None else jnp.asarray(b) for b in batch]))
        with torch.no_grad():
            got = model(*[None if b is None else torch.from_numpy(np.asarray(b)) for b in batch]).numpy()
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= FORWARD_COS
        np.testing.assert_allclose(got, want, atol=FORWARD_ATOL)


def test_each_shared_input_is_quantized_once(tiny):
    """Q1a's calls on the path: q/k/v and gate/up share one quantization of
    their input; every stored projection is one Q1b call."""
    jax_model, jax_cfg, params, (ids, mask, pixels) = tiny
    model = _port_model(tiny, params)
    qd.quantize_params(model, min_dim=16)
    calls = {"rows": 0, "gemm": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    rows, gemm = counting("rows", qd.quantize_rows), counting("gemm", qd.int8_gemm)
    with mock.patch.object(qd, "quantize_rows", rows), mock.patch.object(tl, "quantize_rows", rows), \
            mock.patch.object(qd, "int8_gemm", gemm), torch.no_grad():
        model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixels))
        page = dict(calls)
        calls.update(rows=0, gemm=0)
        model(torch.from_numpy(ids[:, 16:]), torch.from_numpy(mask[:, 16:]))
    # per layer: SigLIP qkv (shared), o, fc1, fc2; Gemma qkv (shared: k/v are 16 wide here), o, gate/up, down
    assert page == {"rows": 2 * 4 + 1 + 2 * 4 + 1, "gemm": 2 * 6 + 1 + 2 * 7 + 1}
    assert calls == {"rows": 2 * 4 + 1, "gemm": 2 * 7 + 1}


def test_quantized_model_keeps_int8_and_fp32_scales_under_to_and_init(tiny):
    model = _port_model(tiny, tiny[2])
    qd.quantize_params(model, min_dim=16)
    up = model.model.language_model.layers[0].mlp.up_proj
    w, s = up.weight.clone(), up.weight_scale.clone()
    model.to(torch.bfloat16)
    hf_init_(model, torch.Generator().manual_seed(0))
    assert up.weight.dtype == torch.int8 and torch.equal(up.weight, w)
    assert up.weight_scale.dtype == torch.float32 and torch.equal(up.weight_scale, s)
    assert model.model.vision_tower.patch_embedding.weight.dtype == torch.bfloat16
    assert next(model.parameters()).device.type == "cpu"  # what QueryEncoder and embed_pages_fused read


def test_export_and_lora_refuse_a_quantized_model(tiny):
    model = _port_model(tiny, tiny[2])
    qd.quantize_params(model, min_dim=16)
    with pytest.raises(ValueError, match="dequantize_params"):
        export_colpali_state_dict(model.state_dict())
    with pytest.raises(ValueError, match="quantize_frozen_base"):
        LoraAdapters(model, LoraSpec(rank=4))
    float_state = _port_model(tiny, tiny[2]).state_dict()
    with pytest.raises(ValueError, match="dequantize_params"):
        model.load_state_dict(float_state)
    qd.dequantize_params(model)
    assert set(export_colpali_state_dict(model.state_dict())) == set(export_colpali_state_dict(float_state))
    LoraAdapters(model, LoraSpec(rank=4)).detach()


# -- load_retriever(quantize=True) on a checkpoint wide enough to quantize ---------------


def _wide_checkpoint(out_dir: Path) -> None:
    """An HF-layout ColPali checkpoint written by the JAX package, one layer
    a tower at 512 wide (so 12 projections quantize at the default
    min_dim), with the synthetic word tokenizer."""
    import validate_checkpoint as vc
    from safetensors.numpy import save_file

    from colpali_tpu.core.hf_export import export_colpali_state_dict as jax_export
    from colpali_tpu.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
    from colpali_tpu.models.paligemma import ColPali as JaxColPali

    out_dir.mkdir(parents=True)
    vision = dict(hidden_size=512, intermediate_size=512, num_hidden_layers=1, num_attention_heads=4,
                  image_size=28, patch_size=14)
    text = dict(vocab_size=128, hidden_size=512, intermediate_size=512, num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=1, head_dim=128, rope_theta=10000.0, rms_norm_eps=1e-6)
    config = PaliGemmaConfig(vision=SiglipVisionConfig(**vision), text=GemmaConfig(**text), projection_dim=512,
                             image_token_index=4)
    model = JaxColPali(config, dim=128, dtype=jnp.float32, param_dtype=jnp.float32)
    ids = np.concatenate([np.full((1, 4), 4, np.int32), np.full((1, 4), 10, np.int32)], axis=1)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids)),
                                 jnp.zeros((1, 28, 28, 3), jnp.float32))["params"]
    state = jax_export(jax.device_get(params))
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, str(out_dir / "model.safetensors"),
              metadata={"format": "pt"})
    (out_dir / "config.json").write_text(json.dumps({
        "model_type": "paligemma", "architectures": ["ColPali"],
        "vision_config": {**vision, "projection_dim": 512, "vision_use_head": False}, "text_config": text,
        "projection_dim": 512, "image_token_index": 4}))
    (out_dir / "preprocessor_config.json").write_text(json.dumps(
        {"size": {"height": 28, "width": 28}, "image_mean": [0.5] * 3, "image_std": [0.5] * 3}))
    vc._save_paligemma_word_tokenizer(str(out_dir))


def test_load_retriever_quantize_matches_jax(tmp_path):
    ckpt = tmp_path / "colpali-512"
    _wide_checkpoint(ckpt)
    jax_model, variables, jax_proc = jax_load_retriever(str(ckpt), family="colpali", dtype=jnp.float32,
                                                        param_dtype=jnp.float32, quantize=True)
    model, proc = load_retriever(str(ckpt), dtype=torch.float32, device="cpu", quantize=True)
    state = model.state_dict()
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    assert set(state) == set(want) and sum(k.endswith("weight_scale") for k in state) == 12
    for key, value in want.items():
        assert torch.equal(state[key], value), key
    assert state["model.language_model.layers.0.self_attn.k_proj.weight"].dtype == torch.float32  # 512 -> 128
    assert state["head.custom_text_proj.weight"].dtype == torch.float32
    queries = ["find document page 0 quarterly report", "what is the total revenue ?"]
    pages = [np.random.default_rng(s).integers(0, 256, size=(40, 30, 3), dtype=np.uint8) for s in range(2)]
    for got_batch, want_batch in ((proc.process_queries(queries), jax_proc.process_queries(queries)),
                                  (proc.process_images(pages), jax_proc.process_images(pages))):
        with torch.no_grad():
            got = model(**{k: torch.from_numpy(np.asarray(v)) for k, v in got_batch.items()}).numpy()
        want = np.asarray(jax.jit(jax_model.apply)(variables, **{k: jnp.asarray(v) for k, v in want_batch.items()}))
        valid = np.linalg.norm(want, axis=-1) > 0
        cos = (got * want).sum(-1)[valid] / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))[valid]
        assert cos.min() >= CKPT_COS
        np.testing.assert_allclose(got, want, atol=CKPT_ATOL)
