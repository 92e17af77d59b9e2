"""Qwen2-VL backbone and the ColQwen2 retriever in PyTorch (counterpart of
:mod:`colpali_tpu.models.qwen2_vl`).

Pages are patchified by the processor (a patch is 3 x 2 x 14 x 14 = 1,176
values, in merge-block order) and padded to one length ``P`` a batch; the
vision tower runs one batched forward with 2-D rotary phases from the
patches' grid positions, attention through K6 with the patch mask as the
segments, and the patch merger (LayerNorm, groups of 4 consecutive patches,
two linears around an exact gelu). The merged features take the
``<|image_pad|>`` slots of the text, and the Qwen2 decoder runs causally
with 3-channel M-RoPE positions (the processor's ``position_ids``, or
positions from the mask when they are absent), left padding allowed.
ColQwen2's head gives 128-d L2-normalized, mask-zeroed token embeddings.
With ``remat=True`` every vision block and decoder layer is checkpointed
(recomputed in the backward), as the JAX package's ``remat`` does.

Module and parameter names follow the JAX package's tree (``blocks_3`` is
``blocks.3``), so :mod:`colpali_tpu_torch.core.from_jax` and the HF rules
map one onto the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
from torch import nn

from colpali_tpu_torch.models.common import DenseHead, MultiVectorHead, merge_image_embeddings
from colpali_tpu_torch.models.configs import DenseHeadConfig
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


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    """Defaults = Qwen2-VL-2B vision tower."""

    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hidden_size: int = 1536  # output dim (= LM hidden)
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_act: str = "quick_gelu"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen2VLVisionConfig":
        return cls(
            depth=cfg.get("depth", 32),
            embed_dim=cfg.get("embed_dim", 1280),
            num_heads=cfg.get("num_heads", 16),
            mlp_ratio=cfg.get("mlp_ratio", 4.0),
            hidden_size=cfg.get("hidden_size", 1536),
            patch_size=cfg.get("patch_size", 14),
            temporal_patch_size=cfg.get("temporal_patch_size", 2),
            spatial_merge_size=cfg.get("spatial_merge_size", 2),
            in_channels=cfg.get("in_channels", 3),
            hidden_act=cfg.get("hidden_act", "quick_gelu"),
        )


@dataclasses.dataclass(frozen=True)
class Qwen2TextConfig:
    """Defaults = Qwen2-VL-2B text decoder."""

    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int = 128
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    mrope_section: tuple = (16, 24, 24)
    attention_bias: bool = True  # bias on q/k/v

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen2TextConfig":
        rope_scaling = cfg.get("rope_scaling") or {}
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=head_dim,
            rope_theta=cfg.get("rope_theta", 1000000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            # without M-RoPE the three position channels are equal: one section is enough
            mrope_section=tuple(rope_scaling.get("mrope_section", (head_dim // 2,))),
            attention_bias=cfg.get("attention_bias", True),
        )


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vision: Qwen2VLVisionConfig = dataclasses.field(default_factory=Qwen2VLVisionConfig)
    text: Qwen2TextConfig = dataclasses.field(default_factory=Qwen2TextConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    video_token_id: int = 151656

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen2VLConfig":
        """From an HF ``config.json``, or from the ``dataclasses.asdict``
        layout that the training export writes (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            return from_export_config(cls, Qwen2VLVisionConfig, cfg)
        text_cfg = cfg.get("text_config", cfg)
        return cls(
            vision=Qwen2VLVisionConfig.from_hf_config(cfg["vision_config"]),
            text=Qwen2TextConfig.from_hf_config(text_cfg),
            image_token_id=cfg.get("image_token_id", 151655),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            video_token_id=cfg.get("video_token_id", 151656),
        )


def from_export_config(cls, vision_cls, cfg: Mapping[str, Any], text_cls=Qwen2TextConfig):
    """A Qwen config from its ``dataclasses.asdict`` form (JSON lists back to
    tuples), as ``training.checkpointing.save_pretrained`` writes it."""
    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    rest = {k: v for k, v in cfg.items() if k in {f.name for f in dataclasses.fields(cls)} - {"vision", "text"}}
    return cls(vision=vision_cls(**fields(cfg["vision"])), text=text_cls(**fields(cfg["text"])), **rest)


def vision_rope(hpos: torch.Tensor, wpos: torch.Tensor, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 2-D rotary tables of the vision towers (HF rot_pos_emb,
    modeling_qwen2_vl.py:673-701): ``(B, P)`` grid positions -> cos/sin
    ``(B, P, head_dim)``; half of each half rotates with the row, half with
    the column."""
    freq_dim = head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (torch.arange(freq_dim, dtype=torch.float32, device=hpos.device) * 2
                                  / (head_dim // 2)))
    half = torch.cat([hpos.float()[..., None] * inv_freq, wpos.float()[..., None] * inv_freq], dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  mrope_section: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """3-channel M-RoPE tables: ``position_ids (3, B, S)`` [temporal, height,
    width] -> cos/sin ``(B, S, head_dim)`` in fp32, section i of the
    (twice repeated) sections taken from channel ``i % 3`` (HF
    apply_multimodal_rotary_pos_emb, modeling_qwen2_vl.py:156-199)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=position_ids.device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, head_dim / 2)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos(), emb.sin()
    sections = list(mrope_section) * 2
    cos_parts = [part[i % 3] for i, part in enumerate(cos.split(sections, dim=-1))]
    sin_parts = [part[i % 3] for i, part in enumerate(sin.split(sections, dim=-1))]
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def merge_patches(ln_q: nn.Module, fc1: QDense, fc2: QDense, x: torch.Tensor, merge: int) -> torch.Tensor:
    """The patch merger: norm, groups of ``merge`` consecutive (merge-ordered)
    patches concatenated, ``fc2(gelu(fc1(.)))``."""
    b, p, d = x.shape
    x = ln_q(x).reshape(b, p // merge, merge * d)
    return fc2(ACTIVATIONS["gelu"](fc1(x)))


class Qwen2VisionBlock(nn.Module):
    def __init__(self, config: Qwen2VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.norm1 = LayerNorm(cfg.embed_dim, eps=1e-6, **kw)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, cfg.head_dim, use_bias=True, out_bias=True, **kw)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=1e-6, **kw)
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = QDense(cfg.embed_dim, hidden, **kw)
        self.fc2 = QDense(hidden, cfg.embed_dim, **kw)

    def forward(self, x: torch.Tensor, segments: torch.Tensor, rope) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope=rope, segments=segments)
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class Qwen2VisionTower(nn.Module):
    """Vision tower over padded per-image patch sequences: ``patches (B, P,
    patch_dim)``, grid positions ``hpos, wpos (B, P)`` and ``patch_mask (B,
    P)`` -> ``(B, P / merge^2, hidden_size)`` merged features (valid groups
    first). Valid patches attend to the valid patches of their image, pad
    patches to pad patches (their features are never spliced in)."""

    def __init__(self, config: Qwen2VLVisionConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = QDense(cfg.patch_dim, cfg.embed_dim, bias=False, **kw)
        self.blocks = nn.ModuleList(Qwen2VisionBlock(cfg, **kw) for _ in range(cfg.depth))
        merge = cfg.spatial_merge_size**2
        self.ln_q = LayerNorm(cfg.embed_dim, eps=1e-6, **kw)
        self.merger_fc1 = QDense(merge * cfg.embed_dim, merge * cfg.embed_dim, **kw)
        self.merger_fc2 = QDense(merge * cfg.embed_dim, cfg.hidden_size, **kw)

    def forward(self, patches, hpos, wpos, patch_mask) -> torch.Tensor:
        cfg = self.config
        x = self.patch_embed(patches.to(self.dtype))
        rope = vision_rope(hpos, wpos, cfg.head_dim)
        segments = patch_mask.to(torch.int32).contiguous()
        for block in self.blocks:
            x = run_layer(block, self.remat, x, segments, rope)
        return merge_patches(self.ln_q, self.merger_fc1, self.merger_fc2, x, cfg.spatial_merge_size**2)


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, config: Qwen2TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, add_unit_offset=False, **kw)
        self.self_attn = Attention(cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                                   num_kv_heads=cfg.num_key_value_heads, use_bias=cfg.attention_bias,
                                   out_bias=False, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, add_unit_offset=False, **kw)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, activation="silu", **kw)

    def forward(self, x: torch.Tensor, segments: torch.Tensor, rope,
                kv_segments: Optional[torch.Tensor] = None) -> torch.Tensor:
        # causal over the valid tokens (segment 1); pad tokens (segment 0) see pad tokens only, or, with the
        # keys' own ids, every row sees the valid keys
        x = x + self.self_attn(self.input_layernorm(x), rope=rope, segments=segments, causal=True,
                               kv_segments=kv_segments)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Decoder(nn.Module):
    """Qwen2(-VL) text decoder over pre-merged input embeddings.

    By default pad tokens attend to pad tokens (the mask as K6's segment
    ids, as the JAX package's flash route does). ``key_padding=True`` gives
    the mask to the keys alone: every row, pad rows too, attends causally to
    the valid keys, as JAX's additive-bias route (``make_attention_bias``)
    and HF do. The Idefics3 decoder pads on the right and takes it, so a pad
    position's hidden state (which ``last`` pooling reads) is JAX's."""

    def __init__(self, config: Qwen2TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False, key_padding: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.key_padding = key_padding
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(Qwen2DecoderLayer(config, device=device, dtype=dtype)
                                    for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, add_unit_offset=False, device=device,
                            dtype=dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        """``position_ids``: ``(3, B, S)`` M-RoPE positions."""
        cfg = self.config
        rope = mrope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
        x = inputs_embeds.to(self.dtype)
        segments = attention_mask.to(torch.int32).contiguous()  # K6's segment ids, converted once
        keys = None
        if self.key_padding:
            segments, keys = torch.ones_like(segments), segments
        for layer in self.layers:
            x = run_layer(layer, self.remat, x, segments, rope, keys)
        return self.norm(x)


def text_positions(attention_mask: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions from the mask, left padding aware (HF
    get_rope_index's text path, modeling_qwen2_vl.py:1053-1058): ``(3, B, S)``."""
    pos = (attention_mask.long().cumsum(-1) - 1).clamp_min(0)
    return pos[None].expand(3, *pos.shape)


class Qwen2VLBackbone(nn.Module):
    """Vision tower + decoder; returns the last hidden states."""

    def __init__(self, config: Qwen2VLConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.visual = Qwen2VisionTower(config.vision, device=device, dtype=dtype, remat=remat)
        self.language_model = Qwen2Decoder(config.text, device=device, dtype=dtype, remat=remat)

    def forward(self, input_ids, attention_mask, pixel_values=None, vision_hpos=None, vision_wpos=None,
                patch_mask=None, position_ids=None) -> torch.Tensor:
        """``input_ids``/``attention_mask`` ``(B, S)``, left padding allowed;
        ``pixel_values (B, P, 1176)`` with the processor's ``vision_hpos``,
        ``vision_wpos`` and ``patch_mask (B, P)``, or None for text;
        ``position_ids (3, B, S)``, else positions from the mask."""
        inputs_embeds = self.language_model.embed(input_ids)
        if pixel_values is not None:
            feats = self.visual(pixel_values, vision_hpos, vision_wpos, patch_mask)
            inputs_embeds = merge_image_embeddings(inputs_embeds, input_ids == self.config.image_token_id, feats)
        if position_ids is None:
            position_ids = text_positions(attention_mask)
        return self.language_model(inputs_embeds, attention_mask, position_ids)


class ColQwen2(nn.Module):
    """Late-interaction retriever over Qwen2-VL (reference
    modeling_colqwen2.py:26-75): ``(B, S, dim)`` L2-normalized, mask-zeroed
    token embeddings. With ``mask_non_image_embeddings``, page inputs also
    zero every non-image token. ``remat`` checkpoints every vision block and
    decoder layer (:meth:`set_remat` turns it on or off later)."""

    def __init__(self, config: Qwen2VLConfig, dim: int = 128, mask_non_image_embeddings: bool = False,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.mask_non_image_embeddings = mask_non_image_embeddings
        self.model = self._backbone(config, device, dtype, remat)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype)

    @staticmethod
    def _backbone(config, device, dtype, remat) -> nn.Module:
        return Qwen2VLBackbone(config, device=device, dtype=dtype, remat=remat)

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.visual.remat = remat
        self.model.language_model.remat = remat

    def forward(self, input_ids, attention_mask, pixel_values=None, **vision_kwargs) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask, pixel_values, **vision_kwargs)
        image_mask = None
        if pixel_values is not None and self.mask_non_image_embeddings:
            image_mask = input_ids == self.config.image_token_id
        return self.head(hidden, attention_mask, image_mask)


class BiQwen2(nn.Module):
    """Single-vector retriever over Qwen2-VL (reference modeling_biqwen2.py):
    :class:`DenseHead` over the backbone, ``last`` pooling by default (the
    processor pads on the left, so the last position is a real token)."""

    def __init__(self, config: Qwen2VLConfig, pooling_strategy: str = "last", device: Device = "cuda",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = self._backbone(config, device, dtype, remat)
        self.head = DenseHead(DenseHeadConfig(pooling_strategy=pooling_strategy), config.text.hidden_size,
                              device=device, dtype=dtype)

    _backbone = staticmethod(ColQwen2._backbone)
    set_remat = ColQwen2.set_remat

    def forward(self, input_ids, attention_mask, pixel_values=None, **vision_kwargs) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values, **vision_kwargs), attention_mask)
