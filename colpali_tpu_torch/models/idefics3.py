"""Idefics3/SmolVLM backbone and the ColIdefics3 (ColSmol) and BiIdefics3
retrievers in PyTorch (counterpart of :mod:`colpali_tpu.models.idefics3`).

A page comes as ``(B, T, S, S, 3)`` normalized tiles (the processor's
sub-images and the global view, zero-padded over T, with ``tile_mask``).
The vision tower, SigLIP's layers over one tile each, runs once over the
``B * T`` tiles; padded tiles go through it as zeros, as in JAX, and their
features are never spliced in. The tower's patch positions are HF's
bucketed coordinates (modeling_idefics3.py:134-160), which even for
full-size tiles are not an arange. The connector is the pixel shuffle (each
``r x r`` block of patches concatenated into one token) and a bias-free
``modality_projection``; the ``B, T * seq`` features take the ``<image>``
slots in order, so a page with fewer tiles than the batch's longest leaves
the trailing (padded) features unused. The text model is the Qwen2 decoder
(Llama/SmolLM2: no q/k/v bias, one rotary section), causal over positions
``cumsum(mask) - 1``, with the processor's right padding under the
key-padding mask (:class:`~colpali_tpu_torch.models.qwen2_vl.Qwen2Decoder`'s
``key_padding``).

Attention runs through K6 at head dim 64 for colSmol-256M's towers (768 / 12
and 576 / 9). Module names follow the JAX tree (``vision_model``,
``modality_projection``, ``text_model``; the ColIdefics3 head ``linear``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from colpali_tpu_torch.models.common import DenseHead, MultiVectorHead, merge_image_embeddings
from colpali_tpu_torch.models.configs import DenseHeadConfig, SiglipVisionConfig
from colpali_tpu_torch.models.layers import Device, QDense, frozen, run_layer
from colpali_tpu_torch.models.qwen2_vl import Qwen2Decoder, Qwen2TextConfig, from_export_config, text_positions
from colpali_tpu_torch.models.siglip import SiglipVisionTower


@dataclasses.dataclass(frozen=True)
class Idefics3VisionConfig:
    """Defaults = SmolVLM vision tower (SigLIP-B/16-512)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 512
    patch_size: int = 16
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Idefics3VisionConfig":
        return cls(
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            image_size=cfg.get("image_size", 512),
            patch_size=cfg.get("patch_size", 16),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-6),
        )


@dataclasses.dataclass(frozen=True)
class Idefics3Config:
    vision: Idefics3VisionConfig = dataclasses.field(default_factory=Idefics3VisionConfig)
    text: Qwen2TextConfig = dataclasses.field(default_factory=Qwen2TextConfig)
    scale_factor: int = 4  # pixel shuffle (SmolVLM: 512/16 = 32 -> 8 x 8 = 64 tokens a tile)
    image_token_id: int = 49153

    @property
    def image_seq_len(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        return (side // self.scale_factor) ** 2

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Idefics3Config":
        """From an HF ``config.json``, or from the ``dataclasses.asdict``
        layout that the training export writes (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            return from_export_config(cls, Idefics3VisionConfig, cfg)
        return cls(
            vision=Idefics3VisionConfig.from_hf_config(cfg["vision_config"]),
            text=Qwen2TextConfig.from_hf_config({**cfg["text_config"], "attention_bias": False}),
            scale_factor=cfg.get("scale_factor", 2),
            image_token_id=cfg.get("image_token_id", 49153),
        )


def pixel_shuffle(x: torch.Tensor, scale_factor: int) -> torch.Tensor:
    """``(B, S, D) -> (B, S / r^2, D * r^2)``, HF Idefics3Connector.pixel_shuffle
    (modeling_idefics3.py:396-405): two reshapes and transposes that gather
    each ``r x r`` block of the square patch grid into one token."""
    bsz, seq, embed_dim = x.shape
    height = width = int(seq**0.5)
    r = scale_factor
    x = x.reshape(bsz, height, width // r, embed_dim * r)
    x = x.permute(0, 2, 1, 3).reshape(bsz, width // r, height // r, embed_dim * r * r)
    return x.permute(0, 2, 1, 3).reshape(bsz, seq // r**2, embed_dim * r**2)


def bucketed_position_ids(image_size: int, patch_size: int) -> np.ndarray:
    """HF Idefics3's patch position ids for a full-size tile: fractional
    coordinates scaled by ``1 - 1e-6`` and bucketed against ``1 / side``
    steps (modeling_idefics3.py:134-160). For ``side`` 4 this is not an
    arange (coordinates 0, 0, 1, 2); the checkpoints were trained on exactly it."""
    side = image_size // patch_size
    boundaries = np.arange(1 / side, 1.0, 1 / side)
    frac = np.arange(side) / side * (1 - 1e-6)
    coord = np.searchsorted(boundaries, frac, side="right")
    return (coord[:, None] * side + coord[None, :]).reshape(-1)


def _as_siglip(cfg: Idefics3VisionConfig) -> SiglipVisionConfig:
    return SiglipVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size, layer_norm_eps=cfg.layer_norm_eps)


class Idefics3VisionTower(SiglipVisionTower):
    """SigLIP's tower over full-size square tiles ``(N, S, S, 3)`` ->
    ``(N, patches, hidden)``, its position embedding looked up at
    :func:`bucketed_position_ids`."""

    def __init__(self, config: Idefics3VisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__(_as_siglip(config), device=device, dtype=dtype, remat=remat)
        ids = torch.from_numpy(bucketed_position_ids(config.image_size, config.patch_size))
        self.register_buffer("position_ids", ids.to(device), persistent=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(self.patchify(pixel_values.to(self.dtype)))
        if x.shape[1] != self.config.num_patches:
            raise ValueError(f"{x.shape[1]} patches, the position embedding has {self.config.num_patches}")
        x = x + self.position_embedding(self.position_ids)
        for layer in self.layers:
            x = run_layer(layer, self.remat, x)
        return self.post_layernorm(x)


class Idefics3Backbone(nn.Module):
    """Vision tower + pixel-shuffle connector + Qwen2 (Llama) decoder;
    returns the last hidden states."""

    def __init__(self, config: Idefics3Config, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.vision_model = Idefics3VisionTower(config.vision, remat=remat, **kw)
        self.modality_projection = QDense(config.vision.hidden_size * config.scale_factor**2,
                                          config.text.hidden_size, bias=False, **kw)
        self.text_model = Qwen2Decoder(config.text, remat=remat, key_padding=True, **kw)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``(B, T, S, S, 3)`` tiles -> ``(B, T * image_seq_len, text hidden)``
        features in tile order; no gradient is recorded when the tower and the
        connector are frozen."""
        b, t = pixel_values.shape[:2]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not (frozen(self.vision_model) and frozen(self.modality_projection))):
            hidden = self.vision_model(pixel_values.reshape(b * t, *pixel_values.shape[2:]))
            feats = self.modality_projection(pixel_shuffle(hidden, self.config.scale_factor))
        return feats.reshape(b, t * feats.shape[1], feats.shape[2])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:  # noqa: ARG002 (JAX's signature)
        """``(B, S)`` right-padded ids and mask, optional ``(B, T, S, S, 3)``
        tiles (valid tiles first in each row; ``tile_mask`` is accepted and,
        as in JAX, not read) -> ``(B, S, text hidden)``."""
        inputs_embeds = self.text_model.embed(input_ids)
        if pixel_values is not None:
            inputs_embeds = merge_image_embeddings(inputs_embeds, input_ids == self.config.image_token_id,
                                                   self.image_features(pixel_values))
        return self.text_model(inputs_embeds, attention_mask, text_positions(attention_mask))


class ColIdefics3(nn.Module):
    """Late-interaction retriever over Idefics3/SmolVLM (ColSmol): ``(B, S,
    dim)`` L2-normalized, mask-zeroed token embeddings; the head's linear is
    named ``linear`` (reference modeling_colidefics3.py:20)."""

    def __init__(self, config: Idefics3Config, dim: int = 128, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = Idefics3Backbone(config, device=device, dtype=dtype, remat=remat)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype, proj_name="linear")

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.vision_model.remat = remat
        self.model.text_model.remat = remat

    def forward(self, input_ids, attention_mask, pixel_values=None, tile_mask=None) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values, tile_mask), attention_mask)


class BiIdefics3(nn.Module):
    """Single-vector retriever over Idefics3: :class:`DenseHead` over the
    backbone, ``last`` pooling by default. The processor pads on the right,
    so on a batch of unequal rows ``last`` reads a pad position for the
    shorter ones, as JAX and the reference do."""

    def __init__(self, config: Idefics3Config, pooling_strategy: str = "last", device: Device = "cuda",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = Idefics3Backbone(config, device=device, dtype=dtype, remat=remat)
        self.head = DenseHead(DenseHeadConfig(pooling_strategy=pooling_strategy), config.text.hidden_size,
                              device=device, dtype=dtype)

    set_remat = ColIdefics3.set_remat

    def forward(self, input_ids, attention_mask, pixel_values=None, tile_mask=None) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values, tile_mask), attention_mask)
