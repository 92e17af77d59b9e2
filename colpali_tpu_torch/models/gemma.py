"""Gemma decoder in PyTorch (counterpart of :mod:`colpali_tpu.models.gemma`).

RMSNorm with unit offset and fp32 statistics, rotary theta 10000 over the
full head, MQA/GQA attention scaled by ``head_dim**-0.5``, gelu-tanh gated
MLP, and the ``sqrt(hidden_size)`` embedding normalizer applied in the
activation dtype. Layers are unrolled (no scan). With ``remat`` each layer
runs under ``torch.utils.checkpoint`` while a gradient is recorded: its
activations are dropped after the forward and recomputed in the backward
(the JAX package's ``remat_layer``, policy "full").
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colpali_tpu_torch.models.configs import GemmaConfig
from colpali_tpu_torch.models.layers import Attention, Device, GatedMLP, RMSNorm, run_layer, rope_cos_sin


class GemmaDecoderLayer(nn.Module):
    def __init__(self, config: GemmaConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw)
        self.self_attn = Attention(
            cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
            num_kv_heads=cfg.num_key_value_heads, **kw,
        )
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, **kw)
        self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size, **kw)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, rope) -> torch.Tensor:
        # full bidirectional attention over valid tokens (PaliGemma prefix)
        x = x + self.self_attn(self.input_layernorm(x), rope=rope, mask=attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class GemmaDecoder(nn.Module):
    """Gemma transformer stack over pre-merged input embeddings."""

    def __init__(self, config: GemmaConfig, device: Device = "cuda", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            GemmaDecoderLayer(config, device=device, dtype=dtype) for _ in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=device, dtype=dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Raw token embeddings (the normalizer is applied in forward)."""
        return self.embed_tokens(input_ids)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        b, s, _ = inputs_embeds.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=inputs_embeds.device).expand(b, s)
        rope = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
        normalizer = torch.tensor(cfg.hidden_size**0.5, dtype=self.dtype, device=inputs_embeds.device)
        x = inputs_embeds.to(self.dtype) * normalizer
        attention_mask = attention_mask.to(torch.int32)  # the segment ids K6 takes, converted once
        for layer in self.layers:
            x = run_layer(layer, self.remat, x, attention_mask, rope)
        return self.norm(x)
