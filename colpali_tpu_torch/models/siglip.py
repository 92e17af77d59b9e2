"""SigLIP vision tower in PyTorch (counterpart of :mod:`colpali_tpu.models.siglip`).

Patch embedding, learned position embedding, pre-LN encoder layers
(attention with biases through kernel K6, gelu-tanh MLP with biases) and a
final ``post_layernorm``; no CLS token and no pooling head, as PaliGemma
uses it. Pixels are NHWC, as in the JAX package. ``remat`` checkpoints each
layer while a gradient is recorded, as in :mod:`colpali_tpu_torch.models.gemma`.

The patch embedding is the JAX package's VALID convolution with stride =
kernel = ``patch_size``, taken as im2col + one matmul: ``patch_embedding``
is an ``nn.Linear`` over ``(patch, patch, channel)``-ordered patch pixels,
the flax ``HWIO`` kernel flattened (see ``core/from_jax.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from colpali_tpu_torch.models.configs import SiglipVisionConfig
from colpali_tpu_torch.models.layers import MLP, Attention, Device, LayerNorm, run_layer


class SiglipEncoderLayer(nn.Module):
    def __init__(self, config: SiglipVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.self_attn = Attention(cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, use_bias=True, **kw)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.mlp = MLP(cfg.hidden_size, cfg.intermediate_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class SiglipVisionTower(nn.Module):
    """``(B, H, W, 3)`` pixel values -> ``(B, num_patches, hidden)``."""

    def __init__(self, config: SiglipVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = config
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.patch_embedding = nn.Linear(cfg.patch_size * cfg.patch_size * 3, cfg.hidden_size, **kw)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def patchify(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, C)`` -> ``(B, (H/p) * (W/p), p * p * C)``, patches in
        row-major order, each flattened as ``(row, column, channel)``."""
        b, h, w, c = pixel_values.shape
        p = self.config.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} is not a whole number of {p}-pixel patches")
        x = pixel_values.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(self.patchify(pixel_values.to(self.dtype)))
        if x.shape[1] != self.config.num_patches:
            raise ValueError(f"{x.shape[1]} patches, the position embedding has {self.config.num_patches}")
        x = x + self.position_embedding.weight
        for layer in self.layers:
            x = run_layer(layer, self.remat, x)
        return self.post_layernorm(x)
