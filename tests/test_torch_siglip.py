"""Port parity: the SigLIP tower and its blocks (colpali_tpu_torch.models)
against colpali_tpu's, at a tiny width in fp32, with the JAX parameters
carried over by core/from_jax.py.

Tolerance: tower outputs atol=1e-4 (LayerNorm'd hidden states of order 1,
fp32 matmuls summed in another order over two layers); blocks atol=2e-6;
bf16 LayerNorm atol=1e-2 (one bf16 rounding of values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.models import layers as jl
from colpali_tpu.models.configs import SiglipVisionConfig as JaxSiglipConfig
from colpali_tpu.models.siglip import SiglipVisionTower as JaxTower
from colpali_tpu_torch.core.from_jax import state_dict_from_jax
from colpali_tpu_torch.models import layers as tl
from colpali_tpu_torch.models.configs import SiglipVisionConfig
from colpali_tpu_torch.models.siglip import SiglipVisionTower

TINY = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4, image_size=42,
            patch_size=14)


def _randomize(params, seed):
    """flax starts biases at 0 and LayerNorm scales at 1: perturb every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05, a.dtype), params)


def test_tower_matches_jax():
    jax_tower = JaxTower(JaxSiglipConfig(**TINY))
    pixels = np.random.default_rng(0).normal(size=(2, 42, 42, 3)).astype(np.float32)
    params = _randomize(jax.jit(jax_tower.init)(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"], 1)
    want = np.asarray(jax.jit(jax_tower.apply)({"params": params}, jnp.asarray(pixels)))

    state = state_dict_from_jax({"model": {"vision_tower": jax.tree.map(np.asarray, params)}})
    tower = SiglipVisionTower(SiglipVisionConfig(**TINY), device="cpu")
    tower.load_state_dict({k.removeprefix("model.vision_tower."): v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape == (2, 9, 48)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_patchify_is_the_valid_conv():
    """im2col + matmul with the flattened HWIO kernel equals the VALID conv."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 28, 42, 3)).astype(np.float32)
    kernel = rng.normal(size=(14, 14, 3, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (14, 14), "VALID",
                                                   dimension_numbers=("NHWC", "HWIO", "NHWC")))
    tower = SiglipVisionTower(SiglipVisionConfig(**TINY), device="cpu")
    got = tower.patchify(torch.from_numpy(x)).numpy() @ kernel.reshape(-1, 5)
    np.testing.assert_allclose(got, want.reshape(1, 6, 5), atol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6), (torch.bfloat16, 1e-2)])
def test_layernorm_matches_flax(dtype, atol):
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.normal(size=(2, 64)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = nn.LayerNorm(epsilon=1e-6, dtype=jdtype).apply({"params": {"scale": w, "bias": b}},
                                                          jnp.asarray(x, jdtype))
    norm = tl.LayerNorm(64, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        norm.bias.copy_(torch.from_numpy(b))
        got = norm(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_mlp_matches():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    jmlp = jl.MLP(intermediate_size=24)
    params = _randomize(jax.jit(jmlp.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    want = np.asarray(jax.jit(jmlp.apply)({"params": params}, jnp.asarray(x)))
    mlp = tl.MLP(16, 24, device="cpu")
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(mlp, name).weight.copy_(torch.tensor(np.asarray(params[name]["kernel"]).T))
            getattr(mlp, name).bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
        np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), want, atol=2e-6)
