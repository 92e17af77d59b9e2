"""Transformer building blocks in PyTorch (counterparts of
:mod:`colpali_tpu.models.layers`, the subset the text tower uses).

Every block takes its parameters' ``device`` and ``dtype``; numerically
sensitive reductions (normalization statistics, softmax, rotary phases) run
in float32 as in the JAX package.

Attention is the JAX einsum path: fp32 logits, additive mask bias, fp32
softmax cast back to the compute dtype, MQA/GQA by grouping query heads.
Query encodes never reach the TPU flash kernel (their padding tax fails
``flash_auto_ok``), so no kernel of this repository runs here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

Device = Optional[torch.device | str]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh, the activation Gemma uses."""
    return F.gelu(x, approximate="tanh")


class RMSNorm(nn.Module):
    """RMS normalization with fp32 statistics, Gemma convention: the weight
    is stored as its deviation from 1."""

    def __init__(self, dim: int, eps: float = 1e-6, device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * (1.0 + self.weight.float())).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 rotary tables: positions ``(B, S)`` -> cos/sin ``(B, S, head_dim)``,
    the second half duplicating the first (rotate-half layout)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over half tables, multiplied in x's own dtype:
    ``concat(x1*c - x2*s, x2*c + x1*s)``. x: ``(B, S, H, Dh)``."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :half].to(x.dtype)
    s = sin[:, :, None, :half].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def make_attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """Additive fp32 ``(B, 1, 1, S)`` bias from a ``(B, S)`` key-validity mask:
    0 where valid, ``finfo(float32).min`` elsewhere (full attention, the
    PaliGemma prefix)."""
    neg = torch.finfo(torch.float32).min
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(attention_mask[:, None, None, :] > 0, zero, neg)


class Attention(nn.Module):
    """Multi-head attention with optional GQA/MQA and rotary embeddings: fp32
    softmax, ``head_dim**-0.5`` scaling, additive bias mask."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int, num_kv_heads: int,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.scale = head_dim**-0.5
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(hidden_size, num_heads * head_dim, **kw)
        self.k_proj = nn.Linear(hidden_size, self.num_kv_heads * head_dim, **kw)
        self.v_proj = nn.Linear(hidden_size, self.num_kv_heads * head_dim, **kw)
        self.o_proj = nn.Linear(num_heads * head_dim, hidden_size, **kw)

    def forward(
        self,
        x: torch.Tensor,
        rope: tuple[torch.Tensor, torch.Tensor],
        mask: torch.Tensor,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        kv, hd = self.num_kv_heads, self.head_dim
        groups = self.num_heads // kv
        q = self.q_proj(x).view(b, s, self.num_heads, hd)
        k = self.k_proj(x).view(b, s, kv, hd)
        v = self.v_proj(x).view(b, s, kv, hd)
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
        qg = q.view(b, s, kv, groups, hd)
        # (B, kv, groups, Sq, Sk) logits with fp32 products and sums
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * self.scale
        logits = logits + make_attention_bias(mask)[:, :, None]
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return self.o_proj(out.reshape(b, s, self.num_heads * hd))


class GatedMLP(nn.Module):
    """Gated MLP: ``down(gelu_tanh(gate(x)) * up(x))``, Gemma style."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 device: Device = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(hidden_size, intermediate_size, **kw)
        self.up_proj = nn.Linear(hidden_size, intermediate_size, **kw)
        self.down_proj = nn.Linear(intermediate_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(gelu_tanh(self.gate_proj(x)) * self.up_proj(x))


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x / ||x||`` in fp32 (NaN on zero rows, as in the JAX package)."""
    xf = x.float()
    return (xf / xf.square().sum(dim=dim, keepdim=True).sqrt()).to(x.dtype)
