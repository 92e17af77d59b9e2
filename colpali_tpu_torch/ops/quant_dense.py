"""Stored-int8 and dynamic w8a8 matmuls: kernels Q1a and Q1b.

Counterpart of :mod:`colpali_tpu.ops.quant_dense`, bit for bit. The scheme
is symmetric int8 with one absmax scale per activation row (computed on the
fly) and one per output channel of the weight:

- :func:`quantize_rows` (kernel Q1a on the card) quantizes each row of
  ``(..., K)``: ``scale = absmax > 0 ? absmax * fp32(1/127) : 1`` and
  ``q = clip(round_half_even(x / scale), -127, 127)`` with a true fp32
  divide. The multiply by ``fp32(1/127)`` is what XLA compiles JAX's
  ``absmax / 127.0`` to under ``jit``, where the JAX forward runs;
  :func:`quantize_rows_eager` divides for real, as JAX does eagerly, which
  is how :func:`quantize_params` quantizes weights there;
- :func:`int8_gemm` (kernel Q1b) multiplies int8 ``(M, K)`` rows by the
  int8 ``(N, K)`` weight into int32 and applies the epilogue
  ``out = cvt((float(acc) * s_row) * s_col)``; a bias is added after that
  rounding to the output dtype, as ``QDense`` adds it in JAX. In fp32 the
  rounding and the add are one: XLA fuses JAX's ``y * s_col + bias`` into
  a fused multiply-add under ``jit`` (a bf16 output rounds in between, so
  nothing fuses there);
- :func:`stored_int8_apply` is the two in turn against a weight quantized
  once by :func:`quantize_params`; :func:`int8_linear` quantizes the weight
  on every call (the dynamic mode, ``quantized_acts()``), falling through
  to the exact product for shapes too small to win.

The weight keeps ``nn.Linear``'s ``(N, K)`` layout, where the JAX package
keeps ``(K, N)``: the card's int8 tensor-core instruction takes both
operands K-major only. Q1b reads its operands by TMA, whose row stride is a
multiple of 16 bytes, so every int8 operand is a ``(rows, K)`` view of a
buffer whose rows are ``K`` rounded up to 16 bytes (:func:`int8_rows`;
Q1a writes its rows so, and ``QDense.store_int8`` stores weights so): any
K takes the kernels, Qwen's 1,176-wide patch embedding and Qwen2.5-VL's
3,420-wide vision ``down_proj`` included. Each kernel wrapper runs its
plain PyTorch version for CPU tensors (the CPU route and the tests' oracle)
and its kernel for CUDA tensors, or raises.

Quantized activations are discontinuous: a one-ulp difference in an input
can flip an int8 value. Single ops are held bit for bit; whole models by
per-token cosine.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from colpali_tpu_torch.ops._cuda import I32, I64, P, CudaKernel, check_cuda, on_cpu

# Below this contraction or output width the int8 path cannot win and small
# projections (the 128-d retrieval head) carry the most per-channel information.
MIN_QUANT_DIM = 512

_INV_127 = float(np.float32(1.0) / np.float32(127.0))

QUANTIZE_ROWS = CudaKernel("colpali_quantize_rows", [P, P, P, I64, I32, I32, I32])  # Q1a
INT8_GEMM = CudaKernel("colpali_int8_gemm", [P, I32, P, P, I32, P, P, P, I32, I32, I32, I32])  # Q1b
OUT_DTYPES = (torch.bfloat16, torch.float32)


def _quantize_last(x: torch.Tensor, divide: bool) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor keeps the divide a true divide on every device
    raw = absmax / torch.full_like(absmax, 127.0) if divide else absmax * _INV_127
    scale = torch.where(absmax > 0, raw, torch.ones_like(absmax))
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1a's plain version: ``(..., K)`` float -> int8 ``(..., K)`` and fp32
    scales ``(..., 1)``, JAX's ``_quantize_rows`` as ``jit`` compiles it."""
    return _quantize_last(x, divide=False)


def quantize_rows_eager(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_quantize_rows`` run eagerly (``absmax / 127`` divided for
    real), in PyTorch ops on any device: how :func:`quantize_params`
    quantizes weights, once."""
    return _quantize_last(x, divide=True)


def row_stride(k: int) -> int:
    """The row stride of an int8 operand of width ``k``: ``k`` rounded up
    to 16 bytes, TMA's rule for a row stride."""
    return -(-k // 16) * 16


def int8_rows(shape: tuple, device, fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An int8 ``(..., K)`` view of a new ``(..., row_stride(K))`` buffer:
    the layout Q1b reads (the columns past K are never read). ``fill``:
    values to copy in; else the view is uninitialized."""
    k = shape[-1]
    buf = torch.empty((*shape[:-1], row_stride(k)), dtype=torch.int8, device=device)
    view = buf[..., :k]
    if fill is not None:
        view.copy_(fill)
    return view


def _check_rows(name: str, t: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``t`` is a 2-D int8 tensor on ``device`` with unit
    column stride and rows on 16-byte boundaries (:func:`int8_rows`)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int8:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int8")
    if t.ndim != 2 or (t.shape[1] > 1 and t.stride(1) != 1) or t.data_ptr() % 16 \
            or (t.shape[0] > 1 and (t.stride(0) % 16 or t.stride(0) < t.shape[1])):
        raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()}: Q1b reads rows that start on 16 bytes "
                         "(make it with quant_dense.int8_rows, or take quantize_rows' output)")


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8, kernel Q1a on the card:
    ``(..., K)`` bf16 or fp32 -> int8 ``(..., K)`` and fp32 scales
    ``(..., 1)``. On the card the int8 rows lie :func:`row_stride` bytes
    apart (:func:`int8_rows`), as Q1b reads them."""
    if on_cpu(x):
        return quantize_rows_plain(x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rows takes bf16 or fp32 on CUDA, got {x.dtype}")
    x = x.contiguous()
    k = x.shape[-1]
    rows = x.numel() // k if k else 0
    q = int8_rows(x.shape, x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows:
        QUANTIZE_ROWS(x.device, x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, k, row_stride(k),
                      int(x.dtype == torch.bfloat16))
    return q, scale


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column (output-channel) symmetric int8 of a JAX-layout ``(K, N)``
    weight -> int8 ``(K, N)`` and fp32 ``(1, N)`` scales (JAX's
    ``_quantize_cols`` under ``jit``): :func:`quantize_rows` of its
    transpose, the port's ``(N, K)`` layout."""
    q, scale = quantize_rows(w.mT.contiguous())
    return q.mT, scale.mT


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32 (fp32 inputs): the product is exact
    in fp64; the fp64 sum and its exact error (TwoSum) decide the one case
    where rounding that sum to fp32 could differ, a sum on a midpoint
    between two fp32 values."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)
    f = s.float()
    toward = torch.nextafter(f, torch.where(s > f.double(), torch.inf, -torch.inf).float())
    tie = (s == (f.double() + toward.double()) * 0.5) & (err != 0)
    return torch.where(tie & ((err > 0) == (toward.double() > f.double())), toward, f)


def int8_gemm_plain(a: torch.Tensor, a_scale: torch.Tensor, b: torch.Tensor, b_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Q1b's plain version. The int8 products are summed in fp64, which is
    exact here (|acc| <= K * 127^2 < 2^53), then rounded to fp32 as an int32
    accumulator converts."""
    y = (a.double() @ b.double().T).float() * a_scale
    if bias is not None and out_dtype == torch.float32:
        return fma_f32(y, b_scale.expand_as(y), bias.float().expand_as(y))
    y = (y * b_scale).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def int8_gemm(a: torch.Tensor, a_scale: torch.Tensor, b: torch.Tensor, b_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel Q1b: ``a (M, K)`` int8 rows with ``a_scale (M, 1)`` times the
    ``b (N, K)`` int8 weight with ``b_scale (N,)`` (fp32 scales) ->
    ``(M, N)`` in ``out_dtype`` (bf16 or fp32), plus ``bias (N,)`` after
    the rounding. On CUDA any K: the rows of ``a`` and ``b`` start on 16
    bytes (:func:`int8_rows`; a contiguous operand with K % 16 == 0 is so)."""
    m, k = a.shape
    n = b.shape[0]
    if b.shape[1] != k or a_scale.shape != (m, 1) or b_scale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"int8_gemm: a {tuple(a.shape)}, a_scale {tuple(a_scale.shape)}, b {tuple(b.shape)}, "
                         f"b_scale {tuple(b_scale.shape)}, bias {None if bias is None else tuple(bias.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"int8_gemm writes bf16 or fp32, not {out_dtype}")
    if on_cpu(a):
        return int8_gemm_plain(a, a_scale, b, b_scale, bias, out_dtype)
    dev = a.device
    _check_rows("a", a, dev)
    _check_rows("b", b, dev)
    check_cuda("a_scale", a_scale, torch.float32, dev)
    check_cuda("b_scale", b_scale, torch.float32, dev)
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
        check_cuda("bias", bias, out_dtype, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m and n:
        lda, ldb = (t.stride(0) if t.shape[0] > 1 else row_stride(k) for t in (a, b))
        INT8_GEMM(dev, a.data_ptr(), lda, a_scale.data_ptr(), b.data_ptr(), ldb, b_scale.data_ptr(),
                  0 if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16))
    return out


def stored_int8_apply(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
                      bias: Optional[torch.Tensor] = None,
                      rows: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``x (..., K)`` against a pre-quantized int8 ``weight (N, K)`` with its
    fp32 per-output-channel ``scale (N,)`` -> ``(..., N)`` in ``out_dtype``:
    Q1a on the activations, then Q1b (``bias`` added after the rounding).
    ``rows``: ``quantize_rows(x)`` already computed for another layer that
    shares ``x`` (the bits are the same)."""
    k = x.shape[-1]
    q, s = rows if rows is not None else quantize_rows(x.reshape(-1, k))
    y = int8_gemm(q.reshape(-1, k), s.reshape(-1, 1), weight, scale, bias, out_dtype)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic w8a8 ``x @ weight.T (+ bias)`` (JAX's ``int8_dot_general``):
    both operands quantized on the call, for a 2-D float ``weight (N, K)``
    with K and N >= :data:`MIN_QUANT_DIM` and a float ``x``. Anything else
    (a batched weight, integer operands, small widths) is the exact product.
    The output dtype is the operands' promoted float type."""
    eligible = (weight.ndim == 2 and x.is_floating_point() and weight.is_floating_point()
                and weight.shape[0] >= MIN_QUANT_DIM and weight.shape[1] >= MIN_QUANT_DIM)
    if not eligible:
        y = torch.matmul(x, weight.transpose(-1, -2))
        return y if bias is None else y + bias
    q, s = quantize_rows(weight)
    return stored_int8_apply(x, q, s.reshape(-1), torch.promote_types(x.dtype, weight.dtype), bias)


def quantization_error(x: torch.Tensor, weight: torch.Tensor) -> float:
    """Relative L2 error of the w8a8 product against the fp32 product
    (diagnostics); ``weight (N, K)``."""
    exact = x.float() @ weight.float().T
    quant = int8_linear(x.float(), weight.float())
    return float((quant - exact).norm() / exact.norm().clamp_min(1e-20))


@torch.no_grad()
def quantize_params(model: nn.Module, min_dim: int = MIN_QUANT_DIM,
                    path_filter: Optional[Callable[[str], bool]] = None) -> List[str]:
    """Store eligible ``QDense`` weights of ``model`` as int8, in place, one
    layer at a time on the weights' own device (each float weight is freed
    as its int8 copy takes its place, so two full copies never coexist).

    Eligibility is the JAX package's over its parameter tree: a float
    ``kernel`` ``(K, N)`` with both dims >= ``min_dim`` whose JAX path (e.g.
    ``model/language_model/layers_0/mlp/up_proj/kernel``) passes
    ``path_filter``. The SigLIP patch embedding (a 4-D convolution kernel in
    JAX, an ``nn.Linear`` here), the embeddings and the norms are never
    quantized. Each layer then holds an int8 ``weight (N, K)`` and a fp32
    ``weight_scale (N,)`` (JAX's ``kernel_scale`` of its ``quant``
    collection). Returns the JAX paths quantized, in module order."""
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.training.lora import jax_kernel_path

    done = []
    for name, mod in model.named_modules():
        if not isinstance(mod, QDense) or mod.stored:
            continue
        path = jax_kernel_path(name)
        if min(mod.weight.shape) < min_dim or (path_filter is not None and not path_filter(path)):
            continue
        q, scale = quantize_rows_eager(mod.weight)
        mod.store_int8(q, scale.reshape(-1))
        done.append(path)
    return done


@torch.no_grad()
def dequantize_params(model: nn.Module, dtype: Optional[torch.dtype] = None) -> List[str]:
    """Inverse of :func:`quantize_params`, in place: each int8 ``QDense``
    weight becomes the float ``q * scale`` in ``dtype`` (default: the
    model's first float parameter's), the values the quantized model
    computed with. Returns the names of the layers converted."""
    from colpali_tpu_torch.models.layers import QDense

    if dtype is None:
        dtype = next(p.dtype for p in model.parameters() if p.is_floating_point())
    done = []
    for name, mod in model.named_modules():
        if isinstance(mod, QDense) and mod.stored:
            mod.store_float(dequantized(mod.weight, mod.weight_scale, dtype))
            done.append(name)
    return done


def dequantized(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``q (N, K)`` int8 times its per-row fp32 ``scale (N,)``, in fp32, cast to ``dtype``."""
    return (q.float() * scale[:, None]).to(dtype)


def dequantize_state_dict(state: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``state`` with every stored-int8 ``weight`` (beside its
    ``weight_scale``) replaced by :func:`dequantized` in ``dtype`` and the
    scales dropped: the float state dict of what the model computes with,
    as :func:`dequantize_params` would leave it, without touching the model."""
    out = dict(state)
    for key in [k for k in state if k.endswith(".weight_scale")]:
        weight = key[: -len("_scale")]
        out[weight] = dequantized(state[weight], out.pop(key), dtype)
    return out
