"""Qwen3.5 (Qwen3-Next) hybrid backbone and the ColQwen3_5 / BiQwen3_5
retrievers in PyTorch (counterpart of :mod:`colpali_tpu.models.qwen3_5`).

- The vision tower is Qwen3-VL's (:class:`~colpali_tpu_torch.models.qwen3_vl.Qwen3VisionTower`);
  its deepstack mergers are loaded but, as in the JAX package, their
  features are not injected, so they are not computed.
- The text decoder repeats a period of ``full_attention_interval`` layers:
  GatedDeltaNet linear attention (the chunked gated delta rule, kernel Q2,
  :mod:`colpali_tpu_torch.ops.gated_delta_rule`) and, every period's last
  layer, gated full attention (q/k RMSNorms with the unit offset, partial
  rotary over the first ``rotary_dim`` dims through interleaved M-RoPE, a
  sigmoid output gate). The full attention runs
  :func:`~colpali_tpu_torch.models.layers.biased_attention` under JAX's
  causal key-padding bias (``make_attention_bias(causal=True)``), its fp32
  logits from the fp32 rotated q and k: no kernel, as JAX computes an
  additive-bias einsum there. MLPs are dense, or sparse MoE (a router, top-k
  experts stacked on a leading axis, a gated shared expert) in JAX's two
  dispatch modes.
- Positions default to ``cumsum(mask) - 1`` on all three channels.

Module and parameter names follow the JAX package's tree (``layers_3`` is
``layers.3``; ``conv1d_kernel (K, C)``, ``A_log``, ``dt_bias`` and
``norm_weight`` keep their names and layouts; the experts' ``gate_proj``,
``up_proj`` ``(E, d, f)`` and ``down_proj`` ``(E, f, d)`` too). ``A_log``
and ``dt_bias`` are fp32 whatever the model's dtype. With ``remat=True``
every vision block and decoder layer is checkpointed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from colpali_tpu_torch.models import layers
from colpali_tpu_torch.models.common import merge_image_embeddings
from colpali_tpu_torch.models.gemma3 import gemma3_attention_bias
from colpali_tpu_torch.models.layers import Device, GatedMLP, QDense, RMSNorm, run_layer, shared_rows
from colpali_tpu_torch.models.qwen2_vl import BiQwen2, ColQwen2, from_export_config, text_positions
from colpali_tpu_torch.models.qwen3_vl import Qwen3VisionTower, Qwen3VLVisionConfig, interleaved_mrope_cos_sin
from colpali_tpu_torch.ops import gated_delta_rule as gdr
from colpali_tpu_torch.ops.gated_delta_rule import chunk_gated_delta_rule  # noqa: F401 (re-exported, as in JAX)


@dataclasses.dataclass(frozen=True)
class Qwen35TextConfig:
    """Hybrid text decoder (Qwen3-Next family); the defaults are the JAX
    package's: Qwen3-Next-80B-A3B's text widths with the experts off."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 5120
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 256
    rope_theta: float = 10_000_000.0
    partial_rotary_factor: float = 0.25
    rms_norm_eps: float = 1e-6
    mrope_section: tuple = ()  # empty -> one section over the rotary dims
    linear_num_value_heads: int = 32
    linear_num_key_heads: int = 16
    linear_key_head_dim: int = 128
    linear_value_head_dim: int = 128
    linear_conv_kernel_dim: int = 4
    full_attention_interval: int = 4
    layer_types: Optional[tuple] = None
    num_experts: int = 0  # 0: dense MLPs
    num_experts_per_tok: int = 10
    moe_intermediate_size: int = 512
    shared_expert_intermediate_size: int = 512
    norm_topk_prob: bool = True
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple = ()
    # > 0: GShard capacity dispatch, ceil(T * K / E * factor) slots an expert; 0: the exact dense dispatch
    moe_capacity_factor: float = 0.0

    def layer_type(self, i: int) -> str:
        if self.layer_types is not None:
            return self.layer_types[i]
        return "full_attention" if (i + 1) % self.full_attention_interval == 0 else "linear_attention"

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and i not in self.mlp_only_layers and (i + 1) % self.decoder_sparse_step == 0

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen35TextConfig":
        rope_scaling = cfg.get("rope_scaling") or {}
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
            rope_theta=cfg.get("rope_theta", 10_000_000.0),
            partial_rotary_factor=cfg.get("partial_rotary_factor", 0.25),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            mrope_section=tuple(rope_scaling.get("mrope_section", ())),
            linear_num_value_heads=cfg.get("linear_num_value_heads", 32),
            linear_num_key_heads=cfg.get("linear_num_key_heads", 16),
            linear_key_head_dim=cfg.get("linear_key_head_dim", 128),
            linear_value_head_dim=cfg.get("linear_value_head_dim", 128),
            linear_conv_kernel_dim=cfg.get("linear_conv_kernel_dim", 4),
            layer_types=tuple(cfg["layer_types"]) if cfg.get("layer_types") else None,
            num_experts=cfg.get("num_experts", 0) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 10),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 512),
            shared_expert_intermediate_size=cfg.get("shared_expert_intermediate_size", 512),
            norm_topk_prob=cfg.get("norm_topk_prob", True),
            decoder_sparse_step=cfg.get("decoder_sparse_step", 1),
            mlp_only_layers=tuple(cfg.get("mlp_only_layers", ()) or ()),
        )


@dataclasses.dataclass(frozen=True)
class Qwen35VLConfig:
    vision: Qwen3VLVisionConfig = dataclasses.field(default_factory=Qwen3VLVisionConfig)
    text: Qwen35TextConfig = dataclasses.field(default_factory=Qwen35TextConfig)
    dim: int = 128  # the reference's getattr(config, "dim", 128)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any]) -> "Qwen35VLConfig":
        """From an HF ``config.json``, or from the ``dataclasses.asdict``
        layout that the training export writes (``vision``/``text``)."""
        if "vision" in cfg and "vision_config" not in cfg:
            return from_export_config(cls, Qwen3VLVisionConfig, cfg, Qwen35TextConfig)
        text_cfg = cfg.get("text_config", cfg)
        return cls(
            vision=Qwen3VLVisionConfig.from_hf_config(cfg["vision_config"]),
            text=Qwen35TextConfig.from_hf_config(text_cfg),
            dim=cfg.get("dim", 128),
            image_token_id=cfg.get("image_token_id", 151655),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
        )


class GatedDeltaNet(nn.Module):
    """Linear-attention token mixer (HF Qwen3NextGatedDeltaNet, :564-775):
    pad tokens zeroed, the per-key-head interleaved ``in_proj_qkvz`` /
    ``in_proj_ba`` layouts, a causal depthwise conv and silu over the q/k/v
    channels, the gated delta rule (Q2), a gated RMSNorm (normalised in
    fp32, times ``silu(z)`` in fp32) and ``out_proj``."""

    def __init__(self, config: Qwen35TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        self.key_dim, self.value_dim = cfg.linear_key_head_dim * hk, cfg.linear_value_head_dim * hv
        kw = dict(bias=False, device=device, dtype=dtype)
        self.in_proj_qkvz = QDense(cfg.hidden_size, 2 * self.key_dim + 2 * self.value_dim, **kw)
        self.in_proj_ba = QDense(cfg.hidden_size, 2 * hv, **kw)
        k = cfg.linear_conv_kernel_dim
        self.conv1d_kernel = nn.Parameter(torch.empty((k, 2 * self.key_dim + self.value_dim), device=device,
                                                      dtype=dtype).uniform_(-k**-0.5, k**-0.5))
        self.A_log = nn.Parameter(torch.zeros(hv, device=device, dtype=torch.float32))
        self.dt_bias = nn.Parameter(torch.ones(hv, device=device, dtype=torch.float32))
        self.norm_weight = nn.Parameter(torch.ones(cfg.linear_value_head_dim, device=device, dtype=dtype))
        self.out_proj = QDense(self.value_dim, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        hk, hv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
        dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
        rep = hv // hk
        x = x * attention_mask[..., None].to(x.dtype)
        rows = shared_rows(x, self.in_proj_qkvz, self.in_proj_ba)
        qkvz = self.in_proj_qkvz(x, rows).view(b, s, hk, 2 * dk + 2 * rep * dv)
        ba = self.in_proj_ba(x, rows).view(b, s, hk, 2 * rep)
        z = qkvz[..., 2 * dk + rep * dv:].reshape(b, s, hv, dv)
        b_gate, a_gate = ba[..., :rep].reshape(b, s, hv), ba[..., rep:].reshape(b, s, hv)
        mixed = torch.cat([qkvz[..., :dk].reshape(b, s, self.key_dim), qkvz[..., dk:2 * dk].reshape(b, s, self.key_dim),
                           qkvz[..., 2 * dk:2 * dk + rep * dv].reshape(b, s, self.value_dim)], dim=-1)
        # the causal depthwise conv: taps over the sequence padded on the left, summed in fp32
        taps = cfg.linear_conv_kernel_dim
        padded = F.pad(mixed, (0, 0, taps - 1, 0))
        kernel = self.conv1d_kernel.to(mixed.dtype).float()
        acc = padded[:, :s].float() * kernel[0]
        for i in range(1, taps):
            acc = acc + padded[:, i:i + s].float() * kernel[i]
        mixed = F.silu(acc.to(mixed.dtype))
        query = mixed[..., :self.key_dim].view(b, s, hk, dk)
        key = mixed[..., self.key_dim:2 * self.key_dim].view(b, s, hk, dk)
        value = mixed[..., 2 * self.key_dim:].view(b, s, hv, dv)
        beta = torch.sigmoid(b_gate)
        g = -torch.exp(self.A_log.float()) * torch.logaddexp(a_gate.float() + self.dt_bias.float(),
                                                             torch.zeros((), device=x.device))
        core = gdr.chunk_gated_delta_rule(query, key, value, g, beta)  # (B, S, Hv, Dv); value head h reads h // rep
        cf = core.float()
        normed = cf * torch.rsqrt(cf.square().mean(dim=-1, keepdim=True) + cfg.rms_norm_eps)
        normed = (self.norm_weight.float() * normed) * F.silu(z.float())
        return self.out_proj(normed.to(x.dtype).reshape(b, s, self.value_dim))


class GatedAttention(nn.Module):
    """Full attention with partial rotary and a sigmoid output gate (HF
    Qwen3NextAttention, :321-400): ``q_proj`` gives each head ``[q | gate]``,
    q/k RMSNorms with the unit offset, rotary over the first ``rotary_dim``
    dims of the fp32 q and k, the biased einsum route, ``out * sigmoid(gate)``."""

    def __init__(self, config: Qwen35TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        nh, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = QDense(cfg.hidden_size, 2 * nh * d, **kw)
        self.k_proj = QDense(cfg.hidden_size, kvh * d, **kw)
        self.v_proj = QDense(cfg.hidden_size, kvh * d, **kw)
        self.o_proj = QDense(nh * d, cfg.hidden_size, **kw)
        self.q_norm = RMSNorm(d, eps=cfg.rms_norm_eps, device=device, dtype=dtype)
        self.k_norm = RMSNorm(d, eps=cfg.rms_norm_eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, rope) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        nh, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        rows = shared_rows(x, self.q_proj, self.k_proj, self.v_proj)
        qg = self.q_proj(x, rows).view(b, s, nh, 2 * d)
        q, gate = qg[..., :d], qg[..., d:]
        k = self.k_proj(x, rows).view(b, s, kvh, d)
        v = self.v_proj(x, rows).view(b, s, kvh, d)
        cos, sin = rope  # (B, S, rotary_dim) fp32
        rd, half = cos.shape[-1], cos.shape[-1] // 2

        def rot(t):  # fp32 in and out, as JAX rotates q.astype(float32)
            t_rot = t[..., :rd]
            rotated = torch.cat([-t_rot[..., half:], t_rot[..., :half]], dim=-1)
            return torch.cat([t_rot * cos[:, :, None] + rotated * sin[:, :, None], t[..., rd:]], dim=-1)

        q, k = rot(self.q_norm(q).float()), rot(self.k_norm(k).float())
        out = layers.biased_attention(q, k, v, attn_bias, d**-0.5, probs_dtype=x.dtype).reshape(b, s, nh * d)
        out = out * torch.sigmoid(gate.reshape(b, s, nh * d).float()).to(x.dtype)
        return self.o_proj(out)


class StackedExperts(nn.Module):
    """Every expert's gated MLP stacked on a leading expert axis:
    ``gate_proj``, ``up_proj (E, d, f)`` and ``down_proj (E, f, d)`` (the
    loader stacks HF's per-expert weights so). ``(E, C, d) -> (E, C, d)``."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = nn.Parameter(torch.empty((num_experts, d_model, d_ff), **kw).normal_(0.0, 0.02))
        self.up_proj = nn.Parameter(torch.empty((num_experts, d_model, d_ff), **kw).normal_(0.0, 0.02))
        self.down_proj = nn.Parameter(torch.empty((num_experts, d_ff, d_model), **kw).normal_(0.0, 0.02))

    def forward(self, xin: torch.Tensor) -> torch.Tensor:
        return torch.bmm(F.silu(torch.bmm(xin, self.gate_proj)) * torch.bmm(xin, self.up_proj), self.down_proj)


class SparseMoeBlock(nn.Module):
    """Router, top-k experts and a gated shared expert (HF
    Qwen3NextSparseMoeBlock, :793-855), the router's softmax in fp32. With
    ``moe_capacity_factor`` 0 every expert computes every token and the
    router weights mask the output (exact); above 0 GShard's dispatch: each
    expert takes ``min(T, ceil(T * K / E * factor))`` tokens, slots claimed
    slot-major (every token's first choice before any second choice), the
    overflow dropped, gathered and scattered by one-hot products."""

    def __init__(self, config: Qwen35TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        kw = dict(device=device, dtype=dtype)
        self.gate = QDense(cfg.hidden_size, cfg.num_experts, bias=False, **kw)
        self.experts = StackedExperts(cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size, **kw)
        self.shared_expert = GatedMLP(cfg.hidden_size, cfg.shared_expert_intermediate_size, activation="silu", **kw)
        self.shared_expert_gate = QDense(cfg.hidden_size, 1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        flat = x.reshape(-1, d)
        tokens, n_exp, k = flat.shape[0], cfg.num_experts, cfg.num_experts_per_tok
        probs = torch.softmax(self.gate(flat).float(), dim=-1)
        top_w, top_i = torch.topk(probs, k, dim=-1)
        if cfg.norm_topk_prob:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        onehot = F.one_hot(top_i, n_exp).float()  # (T, K, E)
        if cfg.moe_capacity_factor > 0:
            capacity = min(tokens, int(math.ceil(tokens * k / n_exp * cfg.moe_capacity_factor)))
            oh_flat = onehot.transpose(0, 1).reshape(k * tokens, n_exp)
            slot = ((torch.cumsum(oh_flat, dim=0) - 1.0) * oh_flat).sum(dim=-1)  # (K * T,)
            keep = (slot < capacity).float()
            slot_oh = (slot.long()[:, None] == torch.arange(capacity, device=x.device)).float()  # none past capacity
            dispatch = ((oh_flat * keep[:, None])[:, :, None] * slot_oh[:, None, :]).reshape(
                k, tokens, n_exp, capacity).transpose(0, 1)  # (T, K, E, C)
            combine = (dispatch * top_w[..., None, None]).sum(dim=1).to(x.dtype)
            dispatch = dispatch.sum(dim=1).to(x.dtype)
            expert_out = self.experts(torch.einsum("td,tec->ecd", flat, dispatch))
            out = torch.einsum("ecd,tec->td", expert_out, combine)
        else:
            w_te = (onehot * top_w[..., None]).sum(dim=1).to(x.dtype)  # (T, E)
            all_out = self.experts(flat[None].expand(n_exp, tokens, d))
            out = torch.einsum("etd,te->td", all_out, w_te)
        shared = self.shared_expert(flat)
        out = out + torch.sigmoid(self.shared_expert_gate(flat).float()).to(x.dtype) * shared
        return out.reshape(b, s, d)


class HybridDecoderLayer(nn.Module):
    def __init__(self, config: Qwen35TextConfig, layer_idx: int, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.linear = cfg.layer_type(layer_idx) == "linear_attention"
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw)
        if self.linear:
            self.linear_attn = GatedDeltaNet(cfg, **kw)
        else:
            self.self_attn = GatedAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw)
        self.mlp = SparseMoeBlock(cfg, **kw) if cfg.is_moe_layer(layer_idx) else \
            GatedMLP(cfg.hidden_size, cfg.intermediate_size, activation="silu", **kw)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, rope, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.input_layernorm(x)
        x = x + (self.linear_attn(h, attention_mask) if self.linear else self.self_attn(h, attn_bias, rope))
        return x + self.mlp(self.post_attention_layernorm(x))


class HybridDecoder(nn.Module):
    """The Qwen3.5 hybrid stack over pre-merged input embeddings."""

    def __init__(self, config: Qwen35TextConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(HybridDecoderLayer(config, i, device=device, dtype=dtype)
                                    for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=device, dtype=dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def forward(self, inputs_embeds: torch.Tensor, attn_bias: torch.Tensor, position_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """``attn_bias (B, 1, S, S)`` (JAX's causal key-padding bias),
        ``position_ids (3, B, S)``, ``attention_mask (B, S)``."""
        cfg = self.config
        rd = cfg.rotary_dim
        # one section over every rotary dim when none is configured (the three channels are equal for text)
        rope = interleaved_mrope_cos_sin(position_ids, rd, cfg.rope_theta, cfg.mrope_section or (rd // 2, 0, 0))
        x = inputs_embeds.to(self.dtype)
        for layer in self.layers:
            x = run_layer(layer, self.remat, x, attn_bias, rope, attention_mask)
        return self.norm(x)


class Qwen35VLBackbone(nn.Module):
    """Qwen3-VL's vision tower + the hybrid decoder; returns the last hidden states."""

    def __init__(self, config: Qwen35VLConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.visual = Qwen3VisionTower(config.vision, device=device, dtype=dtype, remat=remat)
        self.language_model = HybridDecoder(config.text, device=device, dtype=dtype, remat=remat)

    def forward(self, input_ids, attention_mask, pixel_values=None, vision_hpos=None, vision_wpos=None,
                patch_mask=None, pos_idx=None, pos_weight=None, position_ids=None) -> torch.Tensor:
        """Qwen3-VL's inputs (``input_ids``/``attention_mask (B, S)``, left
        padding allowed; the processor's pixels and taps, or None for text;
        ``position_ids (3, B, S)``, else ``cumsum(mask) - 1``)."""
        inputs_embeds = self.language_model.embed(input_ids)
        if pixel_values is not None:
            feats, _ = self.visual(pixel_values, vision_hpos, vision_wpos, patch_mask, pos_idx, pos_weight,
                                   deepstack=False)
            inputs_embeds = merge_image_embeddings(inputs_embeds, input_ids == self.config.image_token_id, feats)
        if position_ids is None:
            position_ids = text_positions(attention_mask)
        # JAX's make_attention_bias(mask, causal=True): Gemma3's bias with no window and no image blocks
        return self.language_model(inputs_embeds, gemma3_attention_bias(attention_mask, None, None), position_ids,
                                   attention_mask)


class ColQwen3_5(ColQwen2):  # noqa: N801 (the reference's name)
    """Late-interaction retriever over the Qwen3.5 hybrid backbone: ColQwen2's
    head, ``dim`` wide (default ``config.dim``, 128)."""

    def __init__(self, config: Qwen35VLConfig, dim: Optional[int] = None, **kwargs):
        if dim is not None and dim != config.dim:
            config = dataclasses.replace(config, dim=dim)
        super().__init__(config, dim=config.dim, **kwargs)

    @staticmethod
    def _backbone(config, device, dtype, remat) -> nn.Module:
        return Qwen35VLBackbone(config, device=device, dtype=dtype, remat=remat)


class BiQwen3_5(BiQwen2):  # noqa: N801 (the reference's name)
    """Single-vector retriever over the Qwen3.5 backbone: BiQwen2's head
    (``last`` pooling by default)."""

    _backbone = staticmethod(ColQwen3_5._backbone)
