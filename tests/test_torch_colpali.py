"""Port parity: the ColPali query forward of colpali_tpu_torch against
colpali_tpu, on the tiny ColPali of ``__graft_entry__._tiny_colpali`` in
fp32, with the JAX parameters carried over by core/from_jax.py.

Tolerance: atol=2e-5 on the L2-normalized outputs (fp32 matmuls and
transcendentals summed and rounded in another order); the building blocks
at atol=1e-6.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _example_batch, _tiny_colpali  # noqa: E402
from colpali_tpu.models import layers as jl  # noqa: E402
from colpali_tpu_torch.core.from_jax import colpali_state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.models import layers as tl  # noqa: E402
from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig  # noqa: E402
from colpali_tpu_torch.models.paligemma import ColPali  # noqa: E402

ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jax_model, jax_cfg = _tiny_colpali(jnp.float32)
    ids, mask, pixels = _example_batch(jax_cfg)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(pixels))
    params = jax.tree.map(np.asarray, variables)
    state, skipped = colpali_state_dict_from_jax(params)
    t = jax_cfg.text
    cfg = PaliGemmaConfig(text=GemmaConfig(**{f: getattr(t, f) for f in GemmaConfig.__dataclass_fields__}),
                          image_token_index=jax_cfg.image_token_index)
    model = ColPali(cfg, dim=jax_model.dim)
    model.load_state_dict(state, strict=True)
    return jax_model, variables, model.eval(), skipped, cfg


def _queries(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text.vocab_size, size=(3, 12)).astype(np.int64)
    ids[0, 4] = cfg.image_token_index  # embeds as id 0
    mask = np.ones_like(ids)
    mask[1, 9:] = 0  # right padding
    mask[2, 5:] = 0
    return ids, mask


def test_skipped_subtrees_are_the_document_slice(models):
    assert models[3] == ["model/multi_modal_projector", "model/vision_tower"]


def test_query_forward_matches(models):
    jax_model, variables, model, _, cfg = models
    ids, mask = _queries(cfg)
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 12, jax_model.dim)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[1, 9:] == 0).all()  # padding is zeroed


def test_pixel_values_raise(models):
    model = models[2]
    with pytest.raises(NotImplementedError, match="document-embedding slice"):
        model(torch.zeros(1, 4, dtype=torch.long), torch.ones(1, 4), pixel_values=torch.zeros(1, 56, 56, 3))


def test_state_dict_layout(models):
    state, _ = colpali_state_dict_from_jax(jax.tree.map(np.asarray, models[1]))
    w = state["model.language_model.layers.1.self_attn.q_proj.weight"]
    k = np.asarray(models[1]["params"]["model"]["language_model"]["layers_1"]["self_attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(w.numpy(), k.T)
    assert set(state) == set(models[2].state_dict())


def test_from_jax_rejects_unknown_params():
    with pytest.raises(ValueError, match="unexpected"):
        colpali_state_dict_from_jax({"params": {"model": {"other": {"w": np.zeros(2)}}}})


def test_rmsnorm_matches():
    x = np.random.default_rng(1).normal(size=(2, 5, 16)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(16,)).astype(np.float32)
    want = np.asarray(jl.RMSNorm().apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x)))
    norm = tl.RMSNorm(16)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        np.testing.assert_allclose(norm(torch.from_numpy(x)).numpy(), want, atol=1e-6)


def test_rope_matches():
    pos = np.arange(1, 9)[None].repeat(2, 0)
    x = np.random.default_rng(3).normal(size=(2, 8, 3, 16)).astype(np.float32)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(tl.apply_rope(torch.from_numpy(x), tc, ts).numpy(), want, atol=1e-6)


def test_attention_bias_and_l2_normalize_match():
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.int32)
    want = np.asarray(jl.make_attention_bias(jnp.asarray(mask), causal=False))  # (B, 1, S, S)
    got = tl.make_attention_bias(torch.from_numpy(mask)).numpy()  # (B, 1, 1, S), broadcast over queries
    np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)
    x = np.random.default_rng(4).normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(x))), atol=1e-6)
