"""Port parity: the ColPali query and page forwards of colpali_tpu_torch
against colpali_tpu, on the tiny ColPali of ``__graft_entry__._tiny_colpali``
(56 px pages, 16 patches) in fp32, with the JAX parameters carried over by
core/from_jax.py.

Tolerance: atol=2e-5 on the L2-normalized outputs (fp32 matmuls and
transcendentals summed and rounded in another order); the building blocks
at atol=1e-6 (LayerNorm 2e-6: flax takes E[x^2] - mean^2 over 64 features).
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
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.models import layers as tl  # noqa: E402
from colpali_tpu.models import common as jc  # noqa: E402
from colpali_tpu_torch.models import common as tc  # noqa: E402
from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig  # noqa: E402
from colpali_tpu_torch.models.paligemma import ColPali  # noqa: E402

ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jax_model, jax_cfg = _tiny_colpali(jnp.float32)
    ids, mask, pixels = _example_batch(jax_cfg)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                                       jnp.asarray(pixels))
    params = jax.tree.map(np.asarray, variables)
    state = state_dict_from_jax(params)
    cfg = port_config(jax_cfg)
    model = ColPali(cfg, dim=jax_model.dim, device="cpu")
    model.load_state_dict(state, strict=True)
    return jax_model, variables, model.eval(), state, cfg


def port_config(jax_cfg) -> PaliGemmaConfig:
    """The port's PaliGemmaConfig with the JAX config's fields."""
    def fields(cls, obj):
        return {f: getattr(obj, f) for f in cls.__dataclass_fields__}

    return PaliGemmaConfig(vision=SiglipVisionConfig(**fields(SiglipVisionConfig, jax_cfg.vision)),
                           text=GemmaConfig(**fields(GemmaConfig, jax_cfg.text)),
                           projection_dim=jax_cfg.projection_dim, image_token_index=jax_cfg.image_token_index)


def _queries(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text.vocab_size, size=(3, 12)).astype(np.int64)
    ids[0, 4] = cfg.image_token_index  # embeds as id 0
    mask = np.ones_like(ids)
    mask[1, 9:] = 0  # right padding
    mask[2, 5:] = 0
    return ids, mask


def test_skipped_subtrees_are_the_document_slice(models):
    """No subtree is skipped any more: the document slice converts too."""
    state = models[3]
    assert any(k.startswith("model.vision_tower.layers.1.self_attn.q_proj") for k in state)
    assert state["model.multi_modal_projector.weight"].shape == (64, 64)
    assert state["model.vision_tower.patch_embedding.weight"].shape == (64, 14 * 14 * 3)
    assert set(state) == set(models[2].state_dict())


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
    """Pixels run now; pixels that are not whole patches, or not the
    configured page size, raise."""
    model = models[2]
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 4, dtype=torch.long), torch.ones(1, 4), pixel_values=torch.zeros(1, 50, 56, 3))
    with pytest.raises(ValueError, match="position embedding"):
        model(torch.zeros(1, 4, dtype=torch.long), torch.ones(1, 4), pixel_values=torch.zeros(1, 70, 56, 3))


def test_state_dict_layout(models):
    state = state_dict_from_jax(jax.tree.map(np.asarray, models[1]))
    w = state["model.language_model.layers.1.self_attn.q_proj.weight"]
    k = np.asarray(models[1]["params"]["model"]["language_model"]["layers_1"]["self_attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(w.numpy(), k.T)
    assert set(state) == set(models[2].state_dict())


def test_from_jax_rejects_unknown_params():
    with pytest.raises(ValueError, match="unexpected"):
        state_dict_from_jax({"params": {"model": {"other": {"w": np.zeros(2)}}}})


def test_rmsnorm_matches():
    x = np.random.default_rng(1).normal(size=(2, 5, 16)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(16,)).astype(np.float32)
    want = np.asarray(jl.RMSNorm().apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x)))
    norm = tl.RMSNorm(16, device="cpu")
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
    """A validity mask passed to the port's attention masks keys as JAX's
    additive bias does (on valid query rows): with q = k = 0 the output is
    the mean of v over the keys the mask lets through."""
    from colpali_tpu_torch.ops.flash_attention import flash_attention_plain

    mask = np.array([[1, 1, 0], [1, 1, 1]], np.int32)
    bias = np.asarray(jl.make_attention_bias(jnp.asarray(mask), causal=False))  # (B, 1, 1, S)
    bias = np.broadcast_to(bias[:, 0], (2, 3, 3))  # the same keys for every query row
    v = np.random.default_rng(4).normal(size=(2, 3, 1, 5)).astype(np.float32)
    want = np.einsum("bqk,bkd->bqd", np.asarray(jax.nn.softmax(jnp.asarray(bias), axis=-1)), v[:, :, 0])
    zeros = torch.zeros(2, 3, 1, 5)
    got = flash_attention_plain(zeros, zeros, torch.from_numpy(v), torch.from_numpy(mask), 1.0)[:, :, 0].numpy()
    np.testing.assert_allclose(got[mask > 0], want[mask > 0], atol=1e-6)
    x = np.random.default_rng(4).normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(x))), atol=1e-6)

def _pages(cfg):
    """``_example_batch``'s page inputs (16 image tokens + 6 text tokens),
    the second row right-padded by two tokens."""
    ids, mask, pixels = _example_batch(cfg)
    mask[1, -2:] = 0
    return ids.astype(np.int64), mask, pixels


@pytest.mark.parametrize("mask_non_image", [False, True])
def test_page_forward_matches(models, mask_non_image):
    jax_model, variables, model, _, cfg = models
    ids, mask, pixels = _pages(cfg)
    jax_page_model = jax_model.clone(mask_non_image_embeddings=mask_non_image)
    want = np.asarray(jax.jit(jax_page_model.apply)(variables, jnp.asarray(ids), jnp.asarray(mask),
                                                    jnp.asarray(pixels)))
    page_model = ColPali(cfg, dim=jax_model.dim, mask_non_image_embeddings=mask_non_image, device="cpu")
    page_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = page_model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (2, 22, jax_model.dim)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[1, -2:] == 0).all()
    if mask_non_image:
        assert (got[:, 16:] == 0).all()


def test_merge_image_embeddings_matches():
    rng = np.random.default_rng(5)
    embeds = rng.normal(size=(2, 7, 4)).astype(np.float32)
    feats = rng.normal(size=(2, 3, 4)).astype(np.float32)
    image_mask = np.array([[1, 1, 1, 0, 0, 0, 0], [0, 1, 0, 1, 1, 1, 1]], bool)  # row 1: more slots than features
    want = np.asarray(jc.merge_image_embeddings(jnp.asarray(embeds), jnp.asarray(image_mask), jnp.asarray(feats)))
    got = tc.merge_image_embeddings(*(torch.from_numpy(a) for a in (embeds, image_mask, feats)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU."""
    import inspect

    from colpali_tpu_torch.models.gemma import GemmaDecoder
    from colpali_tpu_torch.models.paligemma import PaliGemmaBackbone
    from colpali_tpu_torch.models.siglip import SiglipVisionTower
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    for fn in (ColPali, PaliGemmaBackbone, SiglipVisionTower, GemmaDecoder, tc.MultiVectorHead, tl.Attention,
               tl.LayerNorm, tl.RMSNorm, tl.MLP, tl.GatedMLP, CorpusIndex, CorpusIndex.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
