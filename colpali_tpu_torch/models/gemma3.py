"""Gemma3 backbone and the ColGemma3 and BiGemma3 retrievers in PyTorch
(counterpart of :mod:`colpali_tpu.models.gemma3`).

A page is one ``(B, H, W, 3)`` image at the tower's size (896 px for
Gemma3-4B): SigLIP's tower over its 64 x 64 patches (K6 at head dim 72,
S = 4,096), the patch grid average-pooled in row-major order to
``mm_tokens_per_image`` soft tokens (4 x 4 windows: 256 tokens), the
``mm_soft_emb_norm`` RMSNorm (with the tower's ``layer_norm_eps``) and the
raw ``(V, T)`` ``mm_input_projection``, spliced into the
``<image_soft_token>`` slots of the scaled word embeddings (image-token ids
embed as id 0; the ``sqrt(hidden)`` normalizer is rounded to the compute
dtype first: 50.5 in bf16 at width 2,560).

The text decoder is Gemma3's: four RMSNorms a block in sandwich order
(``input_layernorm``, attention, ``post_attention_layernorm``, residual;
``pre_feedforward_layernorm``, the gelu-tanh MLP,
``post_feedforward_layernorm``, residual), per-head q/k RMSNorms before
rope, the scale ``query_pre_attn_scalar**-0.5``, local layers (every
layer but each ``sliding_window_pattern``-th, or as ``layer_types`` says)
on rope theta 10k under a sliding window ``q - k < sliding_window``, global
layers on theta 1M with the positions divided by ``rope_scaling_factor``.
Positions are ``arange(S)`` whatever the (left) padding, as in JAX. The
mask is :func:`gemma3_attention_bias`: causal, OR'd with bidirectional
attention inside each contiguous block of image tokens, padded keys masked
with ``finfo(float32).min`` (not ``-inf``: a left-padded row at position 0
sees no valid key and takes a uniform softmax, where ``-inf`` would give
NaN). Segment ids cannot express it, so the text attention runs the
biased path (:func:`colpali_tpu_torch.models.layers.biased_attention`,
the JAX package's einsum route on XLA; no kernel there either).

Module names follow the JAX tree (``vision_tower``, ``mm_soft_emb_norm``,
``mm_input_projection``, ``language_model``; ColGemma3's head
``custom_text_proj``). ``remat`` checkpoints every layer of both towers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from colpali_tpu_torch.models.common import DenseHead, MultiVectorHead, merge_image_embeddings
from colpali_tpu_torch.models.configs import DenseHeadConfig, SiglipVisionConfig
from colpali_tpu_torch.models.layers import (
    Attention,
    Device,
    GatedMLP,
    RMSNorm,
    frozen,
    rope_cos_sin,
    run_layer,
)
from colpali_tpu_torch.models.siglip import SiglipVisionTower


@dataclasses.dataclass(frozen=True)
class Gemma3TextConfig:
    """Defaults = Gemma3-4B's text decoder (``google/gemma-3-4b-it``)."""

    vocab_size: int = 262208
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 34
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    rope_scaling_factor: float = 8.0  # linear scaling on the full-attention layers
    rms_norm_eps: float = 1e-6
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 1024
    sliding_window_pattern: int = 6  # every 6th layer attends over the full sequence
    layer_types: Optional[tuple] = None

    def layer_type(self, i: int) -> str:
        if self.layer_types is not None:
            return self.layer_types[i]
        return "sliding_attention" if (i + 1) % self.sliding_window_pattern else "full_attention"

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Gemma3TextConfig":
        rope_scaling = cfg.get("rope_scaling") or {}
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim", 256),
            rope_theta=cfg.get("rope_theta", 1_000_000.0),
            rope_local_base_freq=cfg.get("rope_local_base_freq", 10_000.0),
            rope_scaling_factor=rope_scaling.get("factor", 1.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar", 256),
            sliding_window=cfg.get("sliding_window", 1024),
            sliding_window_pattern=cfg.get("sliding_window_pattern", 6),
            layer_types=tuple(cfg["layer_types"]) if cfg.get("layer_types") else None,
        )


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    """Defaults = Gemma3-4B: SigLIP-So400m at 896 px (4,096 patches pooled
    to 256 soft tokens) and :class:`Gemma3TextConfig`."""

    vision: SiglipVisionConfig = dataclasses.field(default_factory=lambda: SiglipVisionConfig(image_size=896))
    text: Gemma3TextConfig = dataclasses.field(default_factory=Gemma3TextConfig)
    mm_tokens_per_image: int = 256
    image_token_index: int = 262144

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Gemma3Config":
        """From an HF ``config.json``, or from the ``dataclasses.asdict``
        layout that the training export writes (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            text = dict(cfg["text"])
            if text.get("layer_types"):
                text["layer_types"] = tuple(text["layer_types"])
            rest = {k: cfg[k] for k in ("mm_tokens_per_image", "image_token_index") if k in cfg}
            return cls(vision=SiglipVisionConfig(**cfg["vision"]), text=Gemma3TextConfig(**text), **rest)
        return cls(
            vision=SiglipVisionConfig.from_hf_config(cfg["vision_config"]),
            text=Gemma3TextConfig.from_hf_config(cfg["text_config"]),
            mm_tokens_per_image=cfg.get("mm_tokens_per_image", 256),
            image_token_index=cfg.get("image_token_index", cfg.get("image_token_id", 262144)),
        )


def gemma3_attention_bias(attention_mask: torch.Tensor, image_token_mask: Optional[torch.Tensor],
                          sliding_window: Optional[int]) -> torch.Tensor:
    """``(B, 1, S, S)`` fp32 additive bias: causal (``q - k < sliding_window``
    too, given one), OR'd with bidirectional attention inside each
    contiguous run of image tokens of a row (HF token_type_ids_mask_function,
    modeling_gemma3.py:729-759), keys where ``attention_mask`` is 0 masked;
    0 where a query sees a key, ``finfo(float32).min`` elsewhere."""
    b, s = attention_mask.shape
    idx = torch.arange(s, device=attention_mask.device)
    q_idx, k_idx = idx[:, None], idx[None, :]
    allowed = k_idx <= q_idx
    if sliding_window is not None:
        allowed = allowed & (q_idx - k_idx < sliding_window)
    allowed = allowed.expand(b, s, s)
    if image_token_mask is not None:
        is_image = image_token_mask.to(torch.int64)
        new_block = is_image * (1 - F.pad(is_image, (1, 0))[:, :-1])
        group = torch.where(image_token_mask, torch.cumsum(new_block, dim=1) - 1, -1)  # (B, S)
        same_image = (group[:, :, None] == group[:, None, :]) & image_token_mask[:, :, None] \
            & image_token_mask[:, None, :]
        allowed = allowed | same_image
    valid_key = attention_mask[:, None, :] > 0
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(allowed & valid_key, zero, torch.finfo(torch.float32).min)[:, None]


class Gemma3DecoderLayer(nn.Module):
    """One Gemma3 block: sandwich RMSNorms around biased attention (q/k
    norms, ``query_pre_attn_scalar**-0.5``) and the gelu-tanh MLP."""

    def __init__(self, config: Gemma3TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            setattr(self, name, RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw))
        self.self_attn = Attention(cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                                   num_kv_heads=cfg.num_key_value_heads, scale=cfg.query_pre_attn_scalar**-0.5,
                                   qk_norm_eps=cfg.rms_norm_eps, **kw)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, **kw)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, rope) -> torch.Tensor:
        x = x + self.post_attention_layernorm(self.self_attn(self.input_layernorm(x), rope=rope, attn_bias=attn_bias))
        return x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))


class Gemma3Decoder(nn.Module):
    """Gemma3's text stack over pre-scaled input embeddings (:meth:`embed`
    applies the ``sqrt(hidden)`` normalizer before the image merge, as HF's
    Gemma3TextScaledWordEmbedding does)."""

    def __init__(self, config: Gemma3TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.layers = nn.ModuleList(Gemma3DecoderLayer(config, **kw) for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings times ``sqrt(hidden)`` rounded to the compute dtype."""
        normalizer = torch.tensor(self.config.hidden_size**0.5, dtype=self.dtype, device=input_ids.device)
        return self.embed_tokens(input_ids) * normalizer

    def forward(self, inputs_embeds: torch.Tensor, attn_bias_full: torch.Tensor, attn_bias_sliding: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        rope_global = rope_cos_sin(position_ids.float() / cfg.rope_scaling_factor, cfg.head_dim, cfg.rope_theta)
        rope_local = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_local_base_freq)
        x = inputs_embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            sliding = cfg.layer_type(i) == "sliding_attention"
            x = run_layer(layer, self.remat, x, attn_bias_sliding if sliding else attn_bias_full,
                          rope_local if sliding else rope_global)
        return self.norm(x)


class Gemma3Backbone(nn.Module):
    """SigLIP tower + average-pool projector + Gemma3 decoder; returns the
    last hidden states."""

    def __init__(self, config: Gemma3Config, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.vision_tower = SiglipVisionTower(config.vision, remat=remat, **kw)
        self.mm_soft_emb_norm = RMSNorm(config.vision.hidden_size, eps=config.vision.layer_norm_eps, **kw)
        self.mm_input_projection = nn.Parameter(torch.zeros(config.vision.hidden_size, config.text.hidden_size, **kw))
        self.language_model = Gemma3Decoder(config.text, remat=remat, **kw)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` pixels -> ``(B, mm_tokens_per_image, text hidden)``:
        the patch grid average-pooled (fp32 sums) in row-major order, normed,
        projected. No gradient is recorded when the tower and the projector
        are frozen."""
        cfg = self.config
        record = torch.is_grad_enabled() and not (frozen(self.vision_tower) and frozen(self.mm_soft_emb_norm)
                                                  and not self.mm_input_projection.requires_grad)
        with torch.set_grad_enabled(record):
            hidden = self.vision_tower(pixel_values)  # (B, P, V)
            b, _, v = hidden.shape
            side = cfg.vision.image_size // cfg.vision.patch_size
            tokens_side = int(cfg.mm_tokens_per_image**0.5)
            k = side // tokens_side
            pooled = hidden.float().reshape(b, tokens_side, k, tokens_side, k, v).sum(dim=(2, 4)) / (k * k)
            normed = self.mm_soft_emb_norm(pooled.to(hidden.dtype).reshape(b, tokens_side * tokens_side, v))
            return torch.matmul(normed, self.mm_input_projection.to(normed.dtype))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``(B, S)`` left-padded ids and mask, optional ``(B, H, W, 3)``
        normalized pixels -> ``(B, S, text hidden)``."""
        cfg = self.config
        image_mask = input_ids == cfg.image_token_index
        inputs_embeds = self.language_model.embed(torch.where(image_mask, 0, input_ids))
        image_token_mask = None
        if pixel_values is not None:
            inputs_embeds = merge_image_embeddings(inputs_embeds, image_mask, self.image_features(pixel_values))
            image_token_mask = image_mask
        bias_full = gemma3_attention_bias(attention_mask, image_token_mask, None)
        bias_sliding = gemma3_attention_bias(attention_mask, image_token_mask, cfg.text.sliding_window)
        b, s = input_ids.shape
        position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
        return self.language_model(inputs_embeds, bias_full, bias_sliding, position_ids)


class ColGemma3(nn.Module):
    """Late-interaction retriever over Gemma3 (reference
    modeling_colgemma.py:20-100): ``(B, S, dim)`` L2-normalized, mask-zeroed
    token embeddings; with ``mask_non_image_embeddings``, page inputs also
    zero every non-image token."""

    def __init__(self, config: Gemma3Config, dim: int = 128, mask_non_image_embeddings: bool = False,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.mask_non_image_embeddings = mask_non_image_embeddings
        self.model = Gemma3Backbone(config, device=device, dtype=dtype, remat=remat)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype)

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.vision_tower.remat = remat
        self.model.language_model.remat = remat

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask, pixel_values)
        image_mask = None
        if pixel_values is not None and self.mask_non_image_embeddings:
            image_mask = input_ids == self.config.image_token_index
        return self.head(hidden, attention_mask, image_mask)


class BiGemma3(nn.Module):
    """Matryoshka single-vector retriever over Gemma3 (reference
    modeling_bigemma.py:7-127): pool (mean by default) -> cut to
    ``embedding_dim`` (768, 1,536 or 2,560 for Gemma3-4B) -> L2 normalize."""

    def __init__(self, config: Gemma3Config, pooling_strategy: str = "mean", embedding_dim: Optional[int] = None,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = Gemma3Backbone(config, device=device, dtype=dtype, remat=remat)
        self.head = DenseHead(DenseHeadConfig(pooling_strategy=pooling_strategy, embedding_dim=embedding_dim),
                              config.text.hidden_size, device=device, dtype=dtype)

    set_remat = ColGemma3.set_remat

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values), attention_mask)
