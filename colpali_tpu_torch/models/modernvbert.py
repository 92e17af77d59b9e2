"""ModernVBERT and the ColModernVBert, BiModernVBert and
ModernVBertForMaskedLM heads in PyTorch (counterpart of
:mod:`colpali_tpu.models.modernvbert`).

A page comes as Idefics3's ``(B, T, S, S, 3)`` normalized tiles. The vision
model is SigLIP's tower (:class:`~colpali_tpu_torch.models.siglip.SiglipVisionTower`,
its position embedding added in ``arange`` order, as JAX builds it: not
Idefics3's bucketed positions) over all ``B * T`` tiles, padded ones too:
``tile_mask`` is accepted and, as in JAX, not read; the merge drops the
features no ``<image>`` slot takes. Idefics3's pixel shuffle and a bias-free
``modality_projection`` make each tile ``image_seq_len`` tokens.

The text model is a bidirectional ModernBERT encoder over the merged
embeddings: :class:`DecoupledEmbed` (ids at or past the base vocabulary
index the additional table, where the image token lies), a bias-free
``emb_norm``, layers of pre-norm attention and a GeGLU MLP (``Wi`` -> input
half, gate half -> ``gelu(input) * gate`` -> ``Wo``; exact erf gelu) with
bias-free LayerNorms (layer 0's ``attn_norm`` is the identity: the
parameter exists, as in JAX, and its output is not used), then
``final_norm``. Every ``global_attn_every_n_layers``-th layer (0, 3, ...)
attends over the whole row at rope theta ``global_rope_theta``; the others
within ``|q - k| <= local_attention // 2`` at ``local_rope_theta``. Both
masks are fp32 additive biases, ``finfo(float32).min`` where a key is a pad
or out of the window (not ``-inf``: a query whose window holds only pads
takes a uniform softmax, as in JAX), built once a forward. Segment ids
cannot express the window, so the text attention runs
:func:`~colpali_tpu_torch.models.layers.biased_attention`, the JAX
package's einsum route (XLA there, no kernel). Rope positions are
``arange(S)``: they count the processor's left pads, as in JAX.

Module names follow the JAX tree (``vision_model``, ``modality_projection``,
``embeddings``, ``text_model`` with ``layers.{i}.attn.{q,k,v,o}_proj``,
``attn_norm``, ``mlp_norm``, ``Wi``, ``Wo``; the ColModernVBert head
``custom_text_proj``), so the LoRA pattern selects JAX's kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from colpali_tpu_torch.models.common import DenseHead, MultiVectorHead, merge_image_embeddings
from colpali_tpu_torch.models.configs import DenseHeadConfig, SiglipVisionConfig
from colpali_tpu_torch.models.idefics3 import pixel_shuffle
from colpali_tpu_torch.models.layers import (
    ACTIVATIONS,
    Attention,
    Device,
    LayerNorm,
    QDense,
    frozen,
    rope_cos_sin,
    run_layer,
)
from colpali_tpu_torch.models.siglip import SiglipVisionTower


@dataclasses.dataclass(frozen=True)
class ModernBertTextConfig:
    """Defaults = the ettin-encoder-150m ModernBERT of ModernVBERT-base."""

    vocab_size: int = 50368
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    norm_eps: float = 1e-5
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    local_attention: int = 128  # window size: a token attends to those within local_attention // 2
    global_attn_every_n_layers: int = 3
    hidden_activation: str = "gelu"
    attention_bias: bool = False
    mlp_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_global(self, i: int) -> bool:
        return i % self.global_attn_every_n_layers == 0

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "ModernBertTextConfig":
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            norm_eps=cfg.get("norm_eps", 1e-5),
            global_rope_theta=cfg.get("global_rope_theta", 160000.0),
            local_rope_theta=cfg.get("local_rope_theta", 10000.0),
            local_attention=cfg.get("local_attention", 128),
            global_attn_every_n_layers=cfg.get("global_attn_every_n_layers", 3),
            hidden_activation=cfg.get("hidden_activation", "gelu"),
            attention_bias=cfg.get("attention_bias", False),
            mlp_bias=cfg.get("mlp_bias", False),
        )


def _modernvbert_vision() -> SiglipVisionConfig:
    """SigLIP2-base-patch16-512: 12 x 768, 12 heads of 64, MLP 3,072, 512 px tiles of 16 px patches."""
    return SiglipVisionConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                              image_size=512, patch_size=16)


@dataclasses.dataclass(frozen=True)
class ModernVBertConfig:
    """Defaults = ModernVBERT-base (``ModernVBERT/colmodernvbert``): the
    SigLIP tower of :func:`_modernvbert_vision`, :class:`ModernBertTextConfig`,
    pixel shuffle by 4 (64 tokens a tile), 128 additional ids, the image token
    50,407 among them."""

    vision: SiglipVisionConfig = dataclasses.field(default_factory=_modernvbert_vision)
    text: ModernBertTextConfig = dataclasses.field(default_factory=ModernBertTextConfig)
    pixel_shuffle_factor: int = 4
    additional_vocab_size: int = 128
    image_token_id: int = 50407

    @property
    def image_seq_len(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        return (side // self.pixel_shuffle_factor) ** 2

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "ModernVBertConfig":
        """From a checkpoint's ``config.json`` as JAX reads it: the reference's
        summary of each backbone (``embed_dim`` read as ``hidden_size``) over
        the full backbone config that ``vision_model_name`` /
        ``text_model_name`` name, resolved against ``_checkpoint_dir``
        (:func:`colpali_tpu_torch.core.hf_loader.load_hf_config` records it)
        or as given; absent keys keep ModernVBERT-base's defaults. Or from
        the ``dataclasses.asdict`` layout that the training export writes
        (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            rest = {k: cfg[k] for k in ("pixel_shuffle_factor", "additional_vocab_size", "image_token_id")
                    if k in cfg}
            return cls(vision=SiglipVisionConfig(**cfg["vision"]), text=ModernBertTextConfig(**cfg["text"]), **rest)
        ckpt_dir = cfg.get("_checkpoint_dir")

        def resolved(sub: Mapping[str, Any], name_key: str) -> Dict[str, Any]:
            merged: Dict[str, Any] = {}
            name = sub.get(name_key)
            if name:
                for path in ([os.path.join(ckpt_dir, name, "config.json")] if ckpt_dir else []) + \
                        [os.path.join(name, "config.json")]:
                    if os.path.exists(path):
                        with open(path) as f:
                            backbone = json.load(f)
                        merged.update(backbone.get("vision_config", backbone))  # a full SiglipModel nests it
                        break
            merged.update(sub)
            if "embed_dim" in merged and "hidden_size" not in merged:
                merged["hidden_size"] = merged["embed_dim"]
            return merged

        kwargs: Dict[str, Any] = {}
        if "vision_config" in cfg:
            kwargs["vision"] = SiglipVisionConfig.from_hf_config(resolved(cfg["vision_config"], "vision_model_name"))
        if "text_config" in cfg:
            kwargs["text"] = ModernBertTextConfig.from_hf_config(resolved(cfg["text_config"], "text_model_name"))
        for key in ("pixel_shuffle_factor", "additional_vocab_size", "image_token_id"):
            if key in cfg:
                kwargs[key] = cfg[key]
        return cls(**kwargs)


class DecoupledEmbed(nn.Module):
    """The base vocabulary's table ``tok_embeddings`` and the additional
    one ``additional_embedding`` (reference DecoupledEmbedding): an id at or
    past ``vocab_size`` reads the second table at ``id - vocab_size`` and
    never indexes the first."""

    def __init__(self, vocab_size: int, additional_vocab_size: int, features: int, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.tok_embeddings = nn.Embedding(vocab_size, features, device=device, dtype=dtype)
        if additional_vocab_size:
            self.additional_embedding = nn.Embedding(additional_vocab_size, features, device=device, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "additional_embedding"):
            return self.tok_embeddings(input_ids)
        extra = input_ids >= self.vocab_size
        base = self.tok_embeddings(torch.where(extra, 0, input_ids))
        added = self.additional_embedding(torch.where(extra, input_ids - self.vocab_size, 0))
        return torch.where(extra[..., None], added, base)


class ModernBertLayer(nn.Module):
    """One ModernBERT block: ``attn_norm`` (the identity on layer 0),
    attention under the layer's bias and rope, residual; ``mlp_norm``, the
    GeGLU ``Wi``/``Wo``, residual."""

    def __init__(self, config: ModernBertTextConfig, layer_idx: int, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.layer_idx = layer_idx
        self.act = ACTIVATIONS[cfg.hidden_activation]
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = LayerNorm(cfg.hidden_size, eps=cfg.norm_eps, bias=False, **kw)
        self.attn = Attention(cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, use_bias=cfg.attention_bias,
                              **kw)
        self.mlp_norm = LayerNorm(cfg.hidden_size, eps=cfg.norm_eps, bias=False, **kw)
        self.Wi = QDense(cfg.hidden_size, 2 * cfg.intermediate_size, bias=cfg.mlp_bias, **kw)
        self.Wo = QDense(cfg.intermediate_size, cfg.hidden_size, bias=cfg.mlp_bias, **kw)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, rope) -> torch.Tensor:
        h = x if self.layer_idx == 0 else self.attn_norm(x)
        x = x + self.attn(h, rope=rope, attn_bias=attn_bias)
        inp, gate = self.Wi(self.mlp_norm(x)).chunk(2, dim=-1)
        return x + self.Wo(self.act(inp) * gate)


def modernbert_attention_biases(attention_mask: torch.Tensor, local_attention: int) -> tuple:
    """The global bias ``(B, 1, 1, S)`` (pad keys masked) and the local one
    ``(B, 1, S, S)`` (pad keys and keys farther than ``local_attention //
    2`` masked): fp32, 0 where a query sees a key, ``finfo(float32).min``
    elsewhere."""
    s = attention_mask.shape[1]
    valid = attention_mask[:, None, None, :] > 0
    idx = torch.arange(s, device=attention_mask.device)
    in_window = (idx[:, None] - idx[None, :]).abs() <= local_attention // 2
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    neg = torch.finfo(torch.float32).min
    return torch.where(valid, zero, neg), torch.where(valid & in_window, zero, neg)


class ModernBertEncoder(nn.Module):
    """The bidirectional ModernBERT stack over pre-merged embeddings."""

    def __init__(self, config: ModernBertTextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        self.emb_norm = LayerNorm(cfg.hidden_size, eps=cfg.norm_eps, bias=False, **kw)
        self.layers = nn.ModuleList(ModernBertLayer(cfg, i, **kw) for i in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, eps=cfg.norm_eps, bias=False, **kw)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s = attention_mask.shape
        x = self.emb_norm(inputs_embeds.to(self.dtype))
        bias_global, bias_local = modernbert_attention_biases(attention_mask, cfg.local_attention)
        positions = torch.arange(s, device=attention_mask.device).expand(b, s)
        rope_global = rope_cos_sin(positions, cfg.head_dim, cfg.global_rope_theta)
        rope_local = rope_cos_sin(positions, cfg.head_dim, cfg.local_rope_theta)
        for i, layer in enumerate(self.layers):
            glob = cfg.is_global(i)
            x = run_layer(layer, self.remat, x, bias_global if glob else bias_local,
                          rope_global if glob else rope_local)
        return self.final_norm(x)


class ModernVBertModel(nn.Module):
    """Vision tower + connector + ModernBERT encoder; returns the last hidden
    states."""

    def __init__(self, config: ModernVBertConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        t = config.text
        self.vision_model = SiglipVisionTower(config.vision, remat=remat, **kw)
        self.modality_projection = QDense(config.vision.hidden_size * config.pixel_shuffle_factor**2, t.hidden_size,
                                          bias=False, **kw)
        self.embeddings = DecoupledEmbed(t.vocab_size, config.additional_vocab_size, t.hidden_size, **kw)
        self.text_model = ModernBertEncoder(t, remat=remat, **kw)

    def image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """``(B, T, S, S, 3)`` tiles -> ``(B, T * image_seq_len, text hidden)``
        features in tile order; no gradient is recorded when the tower and the
        connector are frozen."""
        b, t = pixel_values.shape[:2]
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not (frozen(self.vision_model) and frozen(self.modality_projection))):
            hidden = self.vision_model(pixel_values.reshape(b * t, *pixel_values.shape[2:]))
            feats = self.modality_projection(pixel_shuffle(hidden, self.config.pixel_shuffle_factor))
        return feats.reshape(b, t * feats.shape[1], feats.shape[2])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pixel_values: Optional[torch.Tensor] = None,
                tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:  # noqa: ARG002 (JAX's signature)
        """``(B, S)`` left-padded ids and mask, optional ``(B, T, S, S, 3)``
        tiles (``tile_mask`` is accepted and, as in JAX, not read) -> ``(B,
        S, text hidden)``."""
        inputs_embeds = self.embeddings(input_ids)
        if pixel_values is not None:
            inputs_embeds = merge_image_embeddings(inputs_embeds, input_ids == self.config.image_token_id,
                                                   self.image_features(pixel_values))
        return self.text_model(inputs_embeds, attention_mask)


class ColModernVBert(nn.Module):
    """Late-interaction retriever over ModernVBERT (reference
    modeling_colmodernvbert.py): ``(B, S, dim)`` token embeddings, L2
    normalized with the norm clamped at 1e-12, zeroed at the padding; with
    ``mask_non_image_embeddings``, page inputs also zero every non-image
    token."""

    def __init__(self, config: ModernVBertConfig, dim: int = 128, mask_non_image_embeddings: bool = False,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.mask_non_image_embeddings = mask_non_image_embeddings
        self.model = ModernVBertModel(config, device=device, dtype=dtype, remat=remat)
        self.head = MultiVectorHead(config.text.hidden_size, dim=dim, device=device, dtype=dtype, norm_eps=1e-12)

    def set_remat(self, remat: bool) -> None:
        """Turn the per-layer checkpointing of both towers on or off."""
        self.model.vision_model.remat = remat
        self.model.text_model.remat = remat

    def forward(self, input_ids, attention_mask, pixel_values=None, tile_mask=None) -> torch.Tensor:
        hidden = self.model(input_ids, attention_mask, pixel_values, tile_mask)
        image_mask = None
        if pixel_values is not None and self.mask_non_image_embeddings:
            image_mask = input_ids == self.config.image_token_id
        return self.head(hidden, attention_mask, image_mask)


class BiModernVBert(nn.Module):
    """Single-vector retriever over ModernVBERT (reference
    modeling_bimodernvbert.py): :class:`DenseHead` over the encoder, mean
    pooling by default (``cls`` and ``last`` too)."""

    def __init__(self, config: ModernVBertConfig, pooling_strategy: str = "mean", device: Device = "cuda",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = ModernVBertModel(config, device=device, dtype=dtype, remat=remat)
        self.head = DenseHead(DenseHeadConfig(pooling_strategy=pooling_strategy), config.text.hidden_size,
                              device=device, dtype=dtype)

    set_remat = ColModernVBert.set_remat

    def forward(self, input_ids, attention_mask, pixel_values=None, tile_mask=None) -> torch.Tensor:
        return self.head(self.model(input_ids, attention_mask, pixel_values, tile_mask), attention_mask)


class ModernVBertForMaskedLM(nn.Module):
    """ModernBERT's masked-LM head over ModernVBERT (reference
    modeling_modernvbert.py): ``head_dense`` -> gelu -> ``head_norm`` ->
    ``decoder`` over the base vocabulary, with ``additional_fc``'s logits of
    the additional ids after them."""

    def __init__(self, config: ModernVBertConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        t = config.text
        kw = dict(device=device, dtype=dtype)
        self.act = ACTIVATIONS["gelu"]
        self.model = ModernVBertModel(config, remat=remat, **kw)
        self.head_dense = QDense(t.hidden_size, t.hidden_size, bias=False, **kw)
        self.head_norm = LayerNorm(t.hidden_size, eps=t.norm_eps, bias=False, **kw)
        self.decoder = QDense(t.hidden_size, t.vocab_size, **kw)
        if config.additional_vocab_size:
            self.additional_fc = QDense(t.hidden_size, config.additional_vocab_size, bias=False, **kw)

    set_remat = ColModernVBert.set_remat

    def forward(self, input_ids, attention_mask, pixel_values=None, tile_mask=None) -> torch.Tensor:
        proj = self.head_norm(self.act(self.head_dense(self.model(input_ids, attention_mask, pixel_values,
                                                                  tile_mask))))
        logits = self.decoder(proj)
        if hasattr(self, "additional_fc"):
            logits = torch.cat([logits, self.additional_fc(proj)], dim=-1)
        return logits
