"""Qwen2.5-VL backbone and the ColQwen2_5 retriever in PyTorch (counterpart
of :mod:`colpali_tpu.models.qwen2_5_vl`).

The vision tower is Qwen2-VL's with RMSNorm blocks, a biased SwiGLU MLP, an
RMSNorm ``ln_q`` in the patch merger and window attention: every block but
``fullatt_block_indexes`` attends within 112-pixel windows
(modeling_qwen2_5_vl.py:306-460). HF reorders the patches into window
groups for varlen attention; here the patches keep their merge order and
the windows are K6's segment ids, the processor's per-patch ``window_id``
(-1 on padding); the full-attention blocks take the validity ids (1 valid,
-1 pad). The text decoder is Qwen2's, with M-RoPE.

``Qwen25VLConfig()``'s defaults pair Qwen2.5-VL-3B's vision tower (2,048
out) with Qwen2-VL-2B's 1,536-wide text config, as in the JAX package: a
full-width ColQwen2.5-3B takes its text config from the published
Qwen2.5-VL-3B config (36 x 2,048, 16/2 heads, intermediate 11,008).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn

from colpali_tpu_torch.models.common import merge_image_embeddings
from colpali_tpu_torch.models.layers import Attention, Device, GatedMLP, QDense, RMSNorm, run_layer
from colpali_tpu_torch.models.qwen2_vl import (
    BiQwen2,
    ColQwen2,
    Qwen2Decoder,
    Qwen2TextConfig,
    from_export_config,
    merge_patches,
    text_positions,
    vision_rope,
)


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    """Defaults = Qwen2.5-VL-3B vision tower."""

    depth: int = 32
    hidden_size: int = 1280  # the embed dim (embed_dim in Qwen2-VL)
    num_heads: int = 16
    intermediate_size: int = 3420
    out_hidden_size: int = 2048
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    in_channels: int = 3
    hidden_act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen25VLVisionConfig":
        return cls(
            depth=cfg.get("depth", 32),
            hidden_size=cfg.get("hidden_size", 1280),
            num_heads=cfg.get("num_heads", 16),
            intermediate_size=cfg.get("intermediate_size", 3420),
            out_hidden_size=cfg.get("out_hidden_size", 2048),
            patch_size=cfg.get("patch_size", 14),
            temporal_patch_size=cfg.get("temporal_patch_size", 2),
            spatial_merge_size=cfg.get("spatial_merge_size", 2),
            window_size=cfg.get("window_size", 112),
            fullatt_block_indexes=tuple(cfg.get("fullatt_block_indexes", (7, 15, 23, 31))),
            in_channels=cfg.get("in_channels", 3),
            hidden_act=cfg.get("hidden_act", "silu"),
        )


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    vision: Qwen25VLVisionConfig = dataclasses.field(default_factory=Qwen25VLVisionConfig)
    text: Qwen2TextConfig = dataclasses.field(default_factory=Qwen2TextConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    video_token_id: int = 151656

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen25VLConfig":
        """From an HF ``config.json``, or from the training export's layout."""
        if "vision" in cfg and "vision_config" not in cfg:
            return from_export_config(cls, Qwen25VLVisionConfig, cfg)
        text_cfg = cfg.get("text_config", cfg)
        return cls(
            vision=Qwen25VLVisionConfig.from_hf_config(cfg["vision_config"]),
            text=Qwen2TextConfig.from_hf_config(text_cfg),
            image_token_id=cfg.get("image_token_id", 151655),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            video_token_id=cfg.get("video_token_id", 151656),
        )


class Qwen25VisionBlock(nn.Module):
    def __init__(self, config: Qwen25VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.hidden_size, eps=1e-6, add_unit_offset=False, **kw)
        self.attn = Attention(cfg.hidden_size, cfg.num_heads, cfg.head_dim, use_bias=True, out_bias=True, **kw)
        self.norm2 = RMSNorm(cfg.hidden_size, eps=1e-6, add_unit_offset=False, **kw)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, activation=cfg.hidden_act, bias=True, **kw)

    def forward(self, x: torch.Tensor, segments: torch.Tensor, rope) -> torch.Tensor:
        """``segments``: the window ids, or the validity ids in a full-attention block."""
        x = x + self.attn(self.norm1(x), rope=rope, segments=segments)
        return x + self.mlp(self.norm2(x))


class Qwen25VisionTower(nn.Module):
    """Qwen2.5 vision tower: Qwen2-VL's inputs plus ``window_id (B, P)``
    (-1 on padding) -> ``(B, P / merge^2, out_hidden_size)``."""

    def __init__(self, config: Qwen25VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = QDense(cfg.patch_dim, cfg.hidden_size, bias=False, **kw)
        self.blocks = nn.ModuleList(Qwen25VisionBlock(cfg, **kw) for _ in range(cfg.depth))
        merge = cfg.spatial_merge_size**2
        self.ln_q = RMSNorm(cfg.hidden_size, eps=1e-6, add_unit_offset=False, **kw)
        self.merger_fc1 = QDense(merge * cfg.hidden_size, merge * cfg.hidden_size, **kw)
        self.merger_fc2 = QDense(merge * cfg.hidden_size, cfg.out_hidden_size, **kw)

    def forward(self, patches, hpos, wpos, patch_mask, window_id) -> torch.Tensor:
        cfg = self.config
        x = self.patch_embed(patches.to(self.dtype))
        rope = vision_rope(hpos, wpos, cfg.head_dim)
        seg_full = torch.where(patch_mask.bool(), 1, -1).to(torch.int32).contiguous()
        seg_window = window_id.to(torch.int32).contiguous()
        for i, block in enumerate(self.blocks):
            x = run_layer(block, self.remat, x, seg_full if i in cfg.fullatt_block_indexes else seg_window, rope)
        return merge_patches(self.ln_q, self.merger_fc1, self.merger_fc2, x, cfg.spatial_merge_size**2)


class Qwen25VLBackbone(nn.Module):
    """Vision tower + Qwen2 decoder; returns the last hidden states."""

    def __init__(self, config: Qwen25VLConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.visual = Qwen25VisionTower(config.vision, device=device, dtype=dtype, remat=remat)
        self.language_model = Qwen2Decoder(config.text, device=device, dtype=dtype, remat=remat)

    def forward(self, input_ids, attention_mask, pixel_values=None, vision_hpos=None, vision_wpos=None,
                patch_mask=None, window_id=None, position_ids=None) -> torch.Tensor:
        inputs_embeds = self.language_model.embed(input_ids)
        if pixel_values is not None:
            feats = self.visual(pixel_values, vision_hpos, vision_wpos, patch_mask, window_id)
            inputs_embeds = merge_image_embeddings(inputs_embeds, input_ids == self.config.image_token_id, feats)
        if position_ids is None:
            position_ids = text_positions(attention_mask)
        return self.language_model(inputs_embeds, attention_mask, position_ids)


class ColQwen2_5(ColQwen2):  # noqa: N801 (the reference's name)
    """Late-interaction retriever over Qwen2.5-VL: ColQwen2's head over
    :class:`Qwen25VLBackbone`."""

    @staticmethod
    def _backbone(config, device, dtype, remat) -> nn.Module:
        return Qwen25VLBackbone(config, device=device, dtype=dtype, remat=remat)


class BiQwen2_5(BiQwen2):  # noqa: N801 (the reference's name)
    """Single-vector retriever over Qwen2.5-VL: BiQwen2's head over
    :class:`Qwen25VLBackbone`."""

    _backbone = staticmethod(ColQwen2_5._backbone)
