"""Transformer building blocks in PyTorch (counterparts of
:mod:`colpali_tpu.models.layers`, the subset the ported families use).

Every block takes its parameters' ``device`` (the card unless the caller
asks for the CPU) and ``dtype``; numerically sensitive reductions
(normalization statistics, softmax, rotary phases) run in float32 as in the
JAX package.

Attention runs kernel K6 (:mod:`colpali_tpu_torch.ops.flash_attention`) on
the card and its plain version, the segment-masked einsum, on the CPU: fp32
logits and softmax, MQA/GQA by grouping query heads. A token-validity mask
is passed as segment ids, so valid tokens attend to valid tokens exactly as
under the JAX package's additive mask, and pad rows (masked downstream)
attend to pad tokens. A mask that segment ids cannot express comes as an
additive bias and runs :func:`biased_attention`, the JAX package's einsum
path (XLA there, no kernel), on either device.

The projections are :class:`QDense` layers (the JAX package's ``QDense``):
``nn.Linear`` in the exact mode, stored-int8 weights after
:func:`colpali_tpu_torch.ops.quant_dense.quantize_params`, dynamic w8a8
inside :func:`quantized_acts`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from colpali_tpu_torch.ops import flash_attention as fa
from colpali_tpu_torch.ops.quant_dense import int8_linear, int8_rows, quantize_rows, stored_int8_apply

Device = torch.device | str


def run_layer(layer: nn.Module, remat: bool, *args):
    """``layer(*args)``, checkpointed when ``remat`` is set and autograd is
    recording: the layer's activations are recomputed in the backward
    instead of kept (``torch.utils.checkpoint``, non-reentrant). Random
    draws a layer needs (LoRA dropout masks) must be made before this call:
    the recompute replays the global generator only."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def frozen(module: nn.Module) -> bool:
    """True when no parameter of ``module`` takes a gradient."""
    return not any(p.requires_grad for p in module.parameters())


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh, the activation Gemma and SigLIP use."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu_pytorch_tanh": gelu_tanh,
    "gelu": F.gelu,  # exact (erf), the Qwen patch mergers'
    "silu": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),  # Qwen2-VL's vision blocks
}


class RMSNorm(nn.Module):
    """RMS normalization with fp32 statistics. ``add_unit_offset=True`` is
    the Gemma convention (the weight is stored as its deviation from 1);
    ``False`` is the Qwen/Llama one (the weight is the scale)."""

    def __init__(self, dim: int, eps: float = 1e-6, add_unit_offset: bool = True, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.add_unit_offset = add_unit_offset
        init = torch.zeros if add_unit_offset else torch.ones
        self.weight = nn.Parameter(init(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        w = self.weight.float()
        return (xf * (1.0 + w if self.add_unit_offset else w)).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with flax's statistics: fp32 mean and ``E[x^2] - mean^2``
    variance (clamped at 0), ``(x - mean) * rsqrt(var + eps) * weight + bias``
    in fp32, cast back to the input dtype. ``bias=False`` has no bias
    (flax's ``use_bias=False``: ModernBERT's norms)."""

    def __init__(self, dim: int, eps: float = 1e-6, bias: bool = True, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        out = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (out if self.bias is None else out + self.bias.float()).to(x.dtype)


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


# The dynamic w8a8 mode: QDense layers with float weights quantize them and
# their inputs on every call while this is set (JAX decides it at trace time,
# the port at call time).
_QUANT_CTX: contextvars.ContextVar = contextvars.ContextVar("colpali_tpu_torch_quant_dense", default=False)


@contextlib.contextmanager
def quantized_acts(enable: bool = True):
    """Run the float ``QDense`` projections as dynamic w8a8
    (:func:`colpali_tpu_torch.ops.quant_dense.int8_linear`, which keeps
    shapes below 512 exact) inside this context. For serving forwards."""
    tok = _QUANT_CTX.set(enable)
    try:
        yield
    finally:
        _QUANT_CTX.reset(tok)


class QDense(nn.Linear):
    """``nn.Linear`` with the JAX package's serving quantization policy, in
    three modes decided per call:

    - **stored int8**: ``weight`` is an int8 ``(N, K)`` buffer beside a fp32
      ``weight_scale (N,)`` (:func:`~colpali_tpu_torch.ops.quant_dense.quantize_params`,
      or a quantized state dict loaded into the layer); the product is
      :func:`~colpali_tpu_torch.ops.quant_dense.stored_int8_apply` (kernels
      Q1a and Q1b on the card), in the input's dtype, the bias added after;
    - **dynamic w8a8**: inside :func:`quantized_acts`, ``int8_linear``;
    - **exact** (default): ``nn.Linear``.

    Names and layouts are ``nn.Linear``'s, so loaders, exporters and LoRA
    find the layer as before. ``model.to(dtype)`` converts neither the int8
    weight nor its fp32 scale."""

    @property
    def stored(self) -> bool:
        return self.weight.dtype == torch.int8

    def store_int8(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold ``q (N, K)`` int8 and ``scale (N,)`` fp32 in place of the
        float weight (which is released)."""
        if q.dtype != torch.int8 or q.shape != (self.out_features, self.in_features) or \
                scale.shape != (self.out_features,):
            raise ValueError(f"int8 weight {q.dtype} {tuple(q.shape)} and scale {tuple(scale.shape)} for a "
                             f"{self.in_features} -> {self.out_features} layer")
        del self.weight
        self.register_buffer("weight", int8_rows(q.shape, q.device, fill=q))  # rows on 16 bytes, as Q1b reads them
        self.register_buffer("weight_scale", scale.float())

    def store_float(self, weight: torch.Tensor) -> None:
        """Hold the float ``weight (N, K)`` again, as a parameter."""
        del self.weight, self.weight_scale
        self.weight = nn.Parameter(weight)

    def forward(self, x: torch.Tensor, rows: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """``rows``: :func:`shared_rows` of ``x``, for stored layers that share it."""
        if self.stored:
            return stored_int8_apply(x, self.weight, self.weight_scale, x.dtype, self.bias, rows)
        if _QUANT_CTX.get():
            return int8_linear(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)

    def _apply(self, fn, recurse=True):
        scale = self._buffers.pop("weight_scale", None)  # kept fp32: it follows the weight's device only
        try:
            return super()._apply(fn, recurse)
        finally:
            if scale is not None:
                self._buffers["weight_scale"] = scale.to(self.weight.device)
            w = self.weight
            if self.stored and w.shape[0] > 1 and w.stride(0) % 16:  # a move packed the rows: lay them out again
                self._buffers["weight"] = int8_rows(w.shape, w.device, fill=w)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                              error_msgs):
        # a quantized state dict (int8 weight + weight_scale) turns the layer to stored int8 first
        incoming = state_dict.get(prefix + "weight")
        if prefix + "weight_scale" in state_dict and not self.stored:
            dev = self.weight.device
            self.store_int8(torch.empty(self.weight.shape, dtype=torch.int8, device=dev),
                            torch.empty(self.out_features, dtype=torch.float32, device=dev))
        elif incoming is not None and self.stored and incoming.dtype != torch.int8:
            raise ValueError(f"{prefix}weight: a float weight for a layer holding stored-int8 weights; load it into "
                             "an unquantized model (or call ops.quant_dense.dequantize_params first)")
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys,
                                      error_msgs)


def shared_rows(x: torch.Tensor, *layers: QDense) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """``quantize_rows(x)`` once for two or more stored-int8 ``layers`` that
    take the same input (q/k/v, gate/up), else None (each layer quantizes
    its own input)."""
    if sum(layer.stored for layer in layers) < 2:
        return None
    return quantize_rows(x.reshape(-1, x.shape[-1]))


# fp32 attention-logits budget of the biased path's query chunking (the JAX package's _ATTN_LOGITS_BUDGET)
ATTN_LOGITS_BUDGET = 512 * 1024 * 1024


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attn_bias: torch.Tensor, scale: float,
                     q_chunk: Optional[int] = None, probs_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Attention under an additive bias: the JAX package's einsum path
    (``Attention`` with ``attn_bias``, XLA there, no Pallas kernel), for
    masks that segment ids cannot express (Gemma3's sliding window OR'd with
    bidirectional image blocks).

    ``q (B, S, H, D)``, ``k, v (B, S, Hkv, D)``, ``attn_bias`` broadcastable
    to ``(B, Hkv, Sq, Sk)`` (``(B, 1, S, S)`` or a query-broadcast ``(B, 1,
    1, S)``). Query heads are grouped over their KV head; the logits are
    fp32 products times ``scale`` plus the bias in fp32, the softmax fp32,
    cast to ``probs_dtype`` (default q's dtype) before the product with v
    (Qwen3.5 takes fp32 q and k and bf16 probabilities, as JAX does). Query rows are independent,
    so they run in chunks of ``q_chunk`` rows (default: as many as keep the
    fp32 logits under :data:`ATTN_LOGITS_BUDGET`, a multiple of 128, at
    least 128), which bounds memory at ``O(chunk * S)``."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4).float()  # (B, Hkv, G, S, D)
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]  # (B, Hkv, 1, D, S)
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S, D)
    bias = attn_bias.float()[:, :, None]  # (B, 1 | Hkv, 1, Sq | 1, Sk)
    if q_chunk is None:
        q_chunk = max(128, ATTN_LOGITS_BUDGET // (b * h * s * 4) // 128 * 128)
    blocks = []
    for start in range(0, s, q_chunk):
        rows = slice(start, min(start + q_chunk, s))
        logits = torch.matmul(qg[:, :, :, rows], kt) * scale
        probs = torch.softmax(logits + (bias[..., rows, :] if bias.shape[-2] > 1 else bias), dim=-1).to(
            probs_dtype or q.dtype)
        blocks.append(torch.matmul(probs, vt))
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=3)  # (B, Hkv, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


class Attention(nn.Module):
    """Multi-head attention with optional GQA/MQA, projection biases and
    rotary embeddings through K6, or under an additive bias.

    ``segments`` (B, S) ids or a ``mask`` (B, S) of token validity select
    the keys each query sees (neither: full attention); ``kv_segments``
    gives the keys ids apart from the queries' (K6's ``kv_segments``).
    ``attn_bias`` instead runs :func:`biased_attention` (no kernel: the JAX
    package runs it on XLA) and cannot be combined with them. ``scale``
    defaults to ``head_dim**-0.5``; ``qk_norm_eps`` adds per-head RMSNorms
    ``q_norm``/``k_norm`` over the head dim, applied before rope: Gemma's,
    with the unit offset, or with ``qk_norm_offset=False`` Qwen3's (the
    weight is the scale)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int, num_kv_heads: Optional[int] = None,
                 use_bias: bool = False, out_bias: Optional[bool] = None, scale: Optional[float] = None,
                 qk_norm_eps: Optional[float] = None, qk_norm_offset: bool = True, device: Device = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim
        self.scale = head_dim**-0.5 if scale is None else scale
        kw = dict(device=device, dtype=dtype)
        kv = self.num_kv_heads * head_dim
        self.q_proj = QDense(hidden_size, num_heads * head_dim, bias=use_bias, **kw)
        self.k_proj = QDense(hidden_size, kv, bias=use_bias, **kw)
        self.v_proj = QDense(hidden_size, kv, bias=use_bias, **kw)
        self.o_proj = QDense(num_heads * head_dim, hidden_size, bias=use_bias if out_bias is None else out_bias, **kw)
        if qk_norm_eps is not None:
            self.q_norm = RMSNorm(head_dim, eps=qk_norm_eps, add_unit_offset=qk_norm_offset, **kw)
            self.k_norm = RMSNorm(head_dim, eps=qk_norm_eps, add_unit_offset=qk_norm_offset, **kw)

    def forward(
        self,
        x: torch.Tensor,
        rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        mask: Optional[torch.Tensor] = None,
        segments: Optional[torch.Tensor] = None,
        causal: bool = False,
        kv_segments: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.head_dim
        if attn_bias is not None and (mask is not None or segments is not None or kv_segments is not None or causal):
            raise ValueError("attn_bias cannot be combined with mask, segments, kv_segments or causal (K6 honours "
                             "only segment and causal masking): put the whole mask in the bias")
        rows = shared_rows(x, self.q_proj, self.k_proj, self.v_proj)
        q = self.q_proj(x, rows).view(b, s, self.num_heads, hd)
        k = self.k_proj(x, rows).view(b, s, self.num_kv_heads, hd)
        v = self.v_proj(x, rows).view(b, s, self.num_kv_heads, hd)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        if attn_bias is not None:
            out = biased_attention(q, k, v, attn_bias, self.scale)
        else:
            seg = segments if segments is not None else mask
            if seg is None:
                seg = torch.ones((b, s), dtype=torch.int32, device=x.device)
            keys = {} if kv_segments is None else {"kv_segments": kv_segments.to(torch.int32).contiguous()}
            out = fa.flash_attention(q, k, v, seg.to(torch.int32).contiguous(), self.scale, causal, **keys)
        return self.o_proj(out.reshape(b, s, self.num_heads * hd))


class GatedMLP(nn.Module):
    """Gated MLP: ``down(act(gate(x)) * up(x))``; gelu-tanh (Gemma) by
    default, ``"silu"`` for Qwen. ``bias=True`` puts biases on all three
    projections: the JAX package's ``BiasedGatedMLP`` (Qwen2.5-VL's vision
    blocks, modeling_qwen2_5_vl.py:271)."""

    def __init__(self, hidden_size: int, intermediate_size: int, activation: str = "gelu_pytorch_tanh",
                 bias: bool = False, device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        kw = dict(bias=bias, device=device, dtype=dtype)
        self.gate_proj = QDense(hidden_size, intermediate_size, **kw)
        self.up_proj = QDense(hidden_size, intermediate_size, **kw)
        self.down_proj = QDense(intermediate_size, hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = shared_rows(x, self.gate_proj, self.up_proj)
        return self.down_proj(self.act(self.gate_proj(x, rows)) * self.up_proj(x, rows))


class MLP(nn.Module):
    """Two-layer MLP with biases, SigLIP style: ``fc2(gelu_tanh(fc1(x)))``."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 device: Device = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = QDense(hidden_size, intermediate_size, device=device, dtype=dtype)
        self.fc2 = QDense(intermediate_size, hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """``x / max(||x||, eps)`` in fp32: with ``eps`` 0 NaN on zero rows, as
    in the JAX package; ColModernVBert clamps the norm at 1e-12."""
    xf = x.float()
    norm = xf.square().sum(dim=dim, keepdim=True).sqrt()
    return (xf / (norm.clamp_min(eps) if eps > 0 else norm)).to(x.dtype)
