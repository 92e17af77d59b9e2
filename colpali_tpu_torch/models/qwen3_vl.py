"""Qwen3-VL backbone and the ColQwen3 / BiQwen3 retrievers in PyTorch
(counterpart of :mod:`colpali_tpu.models.qwen3_vl`).

What differs from Qwen2-VL (modeling_qwen3_vl.py):

- The vision tower adds a learned absolute position table, read at each
  patch by four bilinear taps whose indices and weights the processor
  computes on the host (:func:`pos_embed_interp_indices`, HF
  fast_pos_embed_interpolate :642-702); its blocks are LayerNorm blocks with
  a gelu-tanh MLP, attention through K6 (D=72 at Qwen3-VL-4B) with the patch
  mask as the segments.
- Deepstack: the outputs of the vision blocks ``deepstack_visual_indexes``
  go through their own patch mergers (the LayerNorm over the 4 grouped
  patches, ``postshuffle_norm``), and the k-th is added to the hidden states
  at the image positions after decoder layer k (:876-882).
- The text decoder is Qwen3's: per-head q/k RMSNorm without the unit
  offset, no projection biases, and interleaved M-RoPE
  (:func:`interleaved_mrope_cos_sin`, :298-313), causal through K6 (D=128)
  with left padding.
- ColQwen3's head is 320 wide (reference modeling_colqwen3.py:49).

Module and parameter names follow the JAX package's tree (``blocks_3`` is
``blocks.3``, ``deepstack_merger_0`` keeps its name), so
:mod:`colpali_tpu_torch.core.from_jax` and the HF rules map one onto the
other. With ``remat=True`` every vision block and decoder layer is
checkpointed; the deepstack taps are block outputs and come out as well.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from colpali_tpu_torch.models.common import merge_image_embeddings
from colpali_tpu_torch.models.layers import (
    ACTIVATIONS,
    Attention,
    Device,
    GatedMLP,
    LayerNorm,
    QDense,
    RMSNorm,
    run_layer,
)
from colpali_tpu_torch.models.qwen2_vl import BiQwen2, ColQwen2, from_export_config, text_positions, vision_rope


@dataclasses.dataclass(frozen=True)
class Qwen3VLVisionConfig:
    """Defaults = Qwen3-VL-4B vision tower."""

    depth: int = 27
    hidden_size: int = 1152
    num_heads: int = 16
    intermediate_size: int = 4304
    out_hidden_size: int = 2560
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: tuple = (8, 16, 24)
    in_channels: int = 3
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def num_grid_per_side(self) -> int:
        return int(self.num_position_embeddings**0.5)

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen3VLVisionConfig":
        return cls(
            depth=cfg.get("depth", 27),
            hidden_size=cfg.get("hidden_size", 1152),
            num_heads=cfg.get("num_heads", 16),
            intermediate_size=cfg.get("intermediate_size", 4304),
            out_hidden_size=cfg.get("out_hidden_size", 2560),
            patch_size=cfg.get("patch_size", 16),
            temporal_patch_size=cfg.get("temporal_patch_size", 2),
            spatial_merge_size=cfg.get("spatial_merge_size", 2),
            num_position_embeddings=cfg.get("num_position_embeddings", 2304),
            deepstack_visual_indexes=tuple(cfg.get("deepstack_visual_indexes", (8, 16, 24))),
            in_channels=cfg.get("in_channels", 3),
            hidden_act=cfg.get("hidden_act", "gelu_pytorch_tanh"),
        )


@dataclasses.dataclass(frozen=True)
class Qwen3TextConfig:
    """Defaults = Qwen3-VL-4B text decoder."""

    vocab_size: int = 151936
    hidden_size: int = 2560
    intermediate_size: int = 9728
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 5000000.0
    rms_norm_eps: float = 1e-6
    mrope_section: tuple = (24, 20, 20)

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen3TextConfig":
        rope_scaling = cfg.get("rope_scaling") or {}
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
            rope_theta=cfg.get("rope_theta", 5000000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            mrope_section=tuple(rope_scaling.get("mrope_section", (24, 20, 20))),
        )


@dataclasses.dataclass(frozen=True)
class Qwen3VLConfig:
    vision: Qwen3VLVisionConfig = dataclasses.field(default_factory=Qwen3VLVisionConfig)
    text: Qwen3TextConfig = dataclasses.field(default_factory=Qwen3TextConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    video_token_id: int = 151656

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen3VLConfig":
        """From an HF ``config.json``, or from the ``dataclasses.asdict``
        layout that the training export writes (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            return from_export_config(cls, Qwen3VLVisionConfig, cfg, Qwen3TextConfig)
        text_cfg = cfg.get("text_config", cfg)
        return cls(
            vision=Qwen3VLVisionConfig.from_hf_config(cfg["vision_config"]),
            text=Qwen3TextConfig.from_hf_config(text_cfg),
            image_token_id=cfg.get("image_token_id", 151655),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            video_token_id=cfg.get("video_token_id", 151656),
        )


def pos_embed_interp_indices(grid_thw: Sequence[int], num_grid_per_side: int,
                             merge_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Host side: each patch's 4-tap bilinear gather indices ``(P, 4)``
    int32 and weights ``(P, 4)`` float32 into the learned position table,
    in merge-block patch order (HF fast_pos_embed_interpolate,
    modeling_qwen3_vl.py:642-702). ``np.linspace`` runs in float64 and is
    floored to int32, the weights are taken in float64 and cast last, as in
    the JAX package."""
    t, h, w = (int(x) for x in grid_thw)
    side = num_grid_per_side
    h_idxs = np.linspace(0, side - 1, h)
    w_idxs = np.linspace(0, side - 1, w)
    h_floor = h_idxs.astype(np.int32)
    w_floor = w_idxs.astype(np.int32)
    h_ceil = np.clip(h_floor + 1, None, side - 1)
    w_ceil = np.clip(w_floor + 1, None, side - 1)
    dh = (h_idxs - h_floor).astype(np.float32)
    dw = (w_idxs - w_floor).astype(np.float32)
    idx = np.stack([h_floor[:, None] * side + w_floor[None, :], h_floor[:, None] * side + w_ceil[None, :],
                    h_ceil[:, None] * side + w_floor[None, :], h_ceil[:, None] * side + w_ceil[None, :]],
                   axis=-1).reshape(h * w, 4)
    wgt = np.stack([(1 - dh)[:, None] * (1 - dw)[None, :], (1 - dh)[:, None] * dw[None, :],
                    dh[:, None] * (1 - dw)[None, :], dh[:, None] * dw[None, :]], axis=-1).reshape(h * w, 4)
    # row-major (h, w) -> merge-block patch order, repeated over t
    order = np.arange(h * w).reshape(h // merge_size, merge_size, w // merge_size, merge_size)
    order = order.transpose(0, 2, 1, 3).reshape(-1)
    return np.tile(idx[order], (t, 1)).astype(np.int32), np.tile(wgt[order], (t, 1)).astype(np.float32)


def interleaved_mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                              mrope_section: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved M-RoPE tables (HF apply_interleaved_mrope,
    modeling_qwen3_vl.py:298-313): ``position_ids (3, B, S)`` -> cos/sin
    ``(B, S, head_dim)`` in fp32. Frequency ``c`` takes the temporal
    channel, except the height channel where ``c % 3 == 1`` and ``c < 3 *
    section[1]``, and the width channel where ``c % 3 == 2`` and ``c < 3 *
    section[2]``: a selection of channels, not Qwen2's concatenated
    sections."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=position_ids.device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, head_dim / 2)
    chan = torch.arange(head_dim // 2, device=position_ids.device)
    use_h = (chan % 3 == 1) & (chan < 3 * mrope_section[1])
    use_w = (chan % 3 == 2) & (chan < 3 * mrope_section[2])
    mixed = torch.where(use_w, freqs[2], torch.where(use_h, freqs[1], freqs[0]))
    emb = torch.cat([mixed, mixed], dim=-1)
    return emb.cos(), emb.sin()


class Qwen3VisionPatchMerger(nn.Module):
    """norm -> groups of merge^2 (merge-ordered) patches -> fc1 -> exact gelu
    -> fc2 (modeling_qwen3_vl.py:93-105). ``postshuffle_norm`` (the deepstack
    mergers) takes the LayerNorm over the grouped features instead of each
    patch's."""

    def __init__(self, config: Qwen3VLVisionConfig, postshuffle_norm: bool = False, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.merge = config.spatial_merge_size**2
        self.postshuffle_norm = postshuffle_norm
        grouped = self.merge * config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.norm = LayerNorm(grouped if postshuffle_norm else config.hidden_size, eps=1e-6, **kw)
        self.linear_fc1 = QDense(grouped, grouped, **kw)
        self.linear_fc2 = QDense(grouped, config.out_hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, d = x.shape
        if self.postshuffle_norm:
            x = self.norm(x.reshape(b, p // self.merge, self.merge * d))
        else:
            x = self.norm(x).reshape(b, p // self.merge, self.merge * d)
        return self.linear_fc2(ACTIVATIONS["gelu"](self.linear_fc1(x)))


class Qwen3VisionBlock(nn.Module):
    def __init__(self, config: Qwen3VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.norm1 = LayerNorm(cfg.hidden_size, eps=1e-6, **kw)
        self.attn = Attention(cfg.hidden_size, cfg.num_heads, cfg.head_dim, use_bias=True, out_bias=True, **kw)
        self.norm2 = LayerNorm(cfg.hidden_size, eps=1e-6, **kw)
        self.linear_fc1 = QDense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.linear_fc2 = QDense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, segments: torch.Tensor, rope) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope=rope, segments=segments)
        return x + self.linear_fc2(self.act(self.linear_fc1(self.norm2(x))))


class Qwen3VisionTower(nn.Module):
    """Vision tower over padded per-image patch sequences: Qwen2-VL's inputs
    plus the processor's ``pos_idx (B, P, 4)`` and ``pos_weight (B, P, 4)``
    -> ``(merged (B, P / merge^2, out_hidden_size), [deepstack features of
    the same shape, one a tapped block])``."""

    def __init__(self, config: Qwen3VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = QDense(cfg.patch_dim, cfg.hidden_size, **kw)
        self.pos_embed = nn.Embedding(cfg.num_position_embeddings, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(Qwen3VisionBlock(cfg, **kw) for _ in range(cfg.depth))
        for k in range(len(cfg.deepstack_visual_indexes)):
            setattr(self, f"deepstack_merger_{k}", Qwen3VisionPatchMerger(cfg, postshuffle_norm=True, **kw))
        self.merger = Qwen3VisionPatchMerger(cfg, **kw)

    def forward(self, patches, hpos, wpos, patch_mask, pos_idx, pos_weight, deepstack: bool = True):
        """``deepstack=False`` skips the deepstack mergers (Qwen3.5 loads
        them but does not use their features) and returns ``[]`` for them."""
        cfg = self.config
        x = self.patch_embed(patches.to(self.dtype))
        taps = self.pos_embed(pos_idx.long())  # (B, P, 4, hidden)
        x = x + (taps * pos_weight[..., None].to(self.dtype)).sum(dim=2)
        rope = vision_rope(hpos, wpos, cfg.head_dim)
        segments = patch_mask.to(torch.int32).contiguous()
        tapped = []
        for i, block in enumerate(self.blocks):
            x = run_layer(block, self.remat, x, segments, rope)
            if deepstack and i in cfg.deepstack_visual_indexes:
                tapped.append(x)
        deepstack = [getattr(self, f"deepstack_merger_{k}")(tap) for k, tap in enumerate(tapped)]
        return self.merger(x), deepstack


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, config: Qwen3TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, add_unit_offset=False, **kw)
        self.self_attn = Attention(cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                                   num_kv_heads=cfg.num_key_value_heads, use_bias=False,
                                   qk_norm_eps=cfg.rms_norm_eps, qk_norm_offset=False, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, add_unit_offset=False, **kw)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, activation="silu", **kw)

    def forward(self, x: torch.Tensor, segments: torch.Tensor, rope,
                injection: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``injection``: the deepstack feature at this layer's image
        positions (zero elsewhere), added after the MLP's residual."""
        x = x + self.self_attn(self.input_layernorm(x), rope=rope, segments=segments, causal=True)
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if injection is None else x + injection


class Qwen3Decoder(nn.Module):
    """Qwen3 text stack over pre-merged input embeddings, with the deepstack
    features injected into its first layers. Pad tokens attend to pad
    tokens (the mask as K6's segment ids, as in the Qwen2 decoder)."""

    def __init__(self, config: Qwen3TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(config, device=device, dtype=dtype)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, add_unit_offset=False, device=device,
                            dtype=dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, position_ids: torch.Tensor,
                image_mask: Optional[torch.Tensor] = None,
                deepstack: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """``position_ids (3, B, S)``; ``image_mask (B, S)`` and the deepstack
        features ``(B, n_img, D)``: the k-th is scattered to the image
        positions (the j-th image token of a row takes row feature
        ``min(j, n_img - 1)``, zero off the image positions, HF
        _deepstack_process) and added after layer k."""
        cfg = self.config
        rope = interleaved_mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
        x = inputs_embeds.to(self.dtype)
        segments = attention_mask.to(torch.int32).contiguous()  # K6's segment ids, converted once
        injections = [merge_image_embeddings(torch.zeros_like(x), image_mask, ds) for ds in deepstack]
        for i, layer in enumerate(self.layers):
            x = run_layer(layer, self.remat, x, segments, rope, injections[i] if i < len(injections) else None)
        return self.norm(x)


class Qwen3VLBackbone(nn.Module):
    """Vision tower + Qwen3 decoder with deepstack; returns the last hidden states."""

    def __init__(self, config: Qwen3VLConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.visual = Qwen3VisionTower(config.vision, device=device, dtype=dtype, remat=remat)
        self.language_model = Qwen3Decoder(config.text, device=device, dtype=dtype, remat=remat)

    def forward(self, input_ids, attention_mask, pixel_values=None, vision_hpos=None, vision_wpos=None,
                patch_mask=None, pos_idx=None, pos_weight=None, position_ids=None) -> torch.Tensor:
        """``input_ids``/``attention_mask`` ``(B, S)``, left padding allowed;
        ``pixel_values (B, P, patch_dim)`` with the processor's
        ``vision_hpos``, ``vision_wpos``, ``patch_mask (B, P)``, ``pos_idx``
        and ``pos_weight (B, P, 4)``, or None for text; ``position_ids (3,
        B, S)``, else positions from the mask."""
        inputs_embeds = self.language_model.embed(input_ids)
        image_mask, deepstack = None, ()
        if pixel_values is not None:
            feats, deepstack = self.visual(pixel_values, vision_hpos, vision_wpos, patch_mask, pos_idx, pos_weight)
            image_mask = input_ids == self.config.image_token_id
            inputs_embeds = merge_image_embeddings(inputs_embeds, image_mask, feats)
        if position_ids is None:
            position_ids = text_positions(attention_mask)
        return self.language_model(inputs_embeds, attention_mask, position_ids, image_mask, deepstack)


class ColQwen3(ColQwen2):
    """Late-interaction retriever over Qwen3-VL: ColQwen2's head, 320 wide
    by default (reference modeling_colqwen3.py:49), over
    :class:`Qwen3VLBackbone`."""

    def __init__(self, config: Qwen3VLConfig, dim: int = 320, **kwargs):
        super().__init__(config, dim=dim, **kwargs)

    @staticmethod
    def _backbone(config, device, dtype, remat) -> nn.Module:
        return Qwen3VLBackbone(config, device=device, dtype=dtype, remat=remat)


class BiQwen3(BiQwen2):
    """Single-vector retriever over Qwen3-VL: BiQwen2's head (``last``
    pooling by default) over :class:`Qwen3VLBackbone`."""

    _backbone = staticmethod(ColQwen3._backbone)
