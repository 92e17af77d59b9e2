"""Carry a JAX parameter tree over to the port's state dict.

The JAX package's ``ColPali``, ``ColQwen2``, ``ColQwen2_5``, ``ColQwen3``,
``ColQwen3_5``, ``ColIdefics3``, ``ColGemma3`` or ``ColModernVBert`` params, or those of a Bi
model (``DenseHead``'s ``head/proj`` included) or of ``ModernVBertForMaskedLM``, a nested dict with numpy leaves as ``jax.tree.map(np.asarray,
variables)`` gives them, become the state dict of the port's model of the
same name:

- flax ``Dense`` kernels ``(in, out)`` become ``nn.Linear`` weights ``(out, in)``;
- the SigLIP (and Idefics3) patch ``Conv`` kernel ``(p, p, 3, hidden)`` (HWIO) becomes the
  im2col ``nn.Linear`` weight ``(hidden, p * p * 3)`` (Qwen's patch embedding
  is a ``Dense`` already);
- ``embedding`` leaves (token and position embeddings) become ``weight``;
- Gemma3's ``mm_input_projection``, a raw ``(V, T)`` parameter and no
  ``Dense``, is taken as it is (the RMSNorms' ``weight``, the q/k norms
  and the four norms of a block included, keep their names);
- flax ``LayerNorm`` ``scale`` becomes ``weight`` (``bias`` stays, where
  there is one: ModernBERT's norms have none);
- Qwen3-VL's learned position table ``pos_embed/embedding`` becomes
  ``pos_embed.weight`` and its ``deepstack_merger_{k}`` keep their names;
- unrolled ``layers_{i}`` and ``blocks_{i}`` become ``layers.{i}`` and ``blocks.{i}``;
  a scanned stack (``scan_layers=True``: ``layers/layer/...`` or
  ``blocks/layer/...`` with a leading layer axis) is unrolled first, and so
  is Qwen3.5's stack of hybrid periods (``layers/layer/sub_{j}/...`` with a
  leading period axis: period ``p``'s ``sub_{j}`` is layer ``p * P + j``);
- Qwen3.5's raw leaves (``conv1d_kernel (K, C)``, ``A_log``, ``dt_bias``,
  ``norm_weight`` and the stacked experts ``gate_proj``, ``up_proj`` and
  ``down_proj``) are taken as they are;
- a stored-int8 tree (``quantize_params``' ``(qp, qc)``): each int8
  ``kernel (K, N)`` becomes the int8 ``weight (N, K)`` and the ``quant``
  collection's ``kernel_scale (1, N)`` its fp32 ``weight_scale (N,)``; a
  model takes them through ``load_state_dict`` (``QDense`` layers turn to
  stored int8 as they load).

bf16 leaves (``ml_dtypes.bfloat16``) are taken bit for bit.

:func:`lora_from_jax` carries a JAX LoRA adapter tree over likewise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_CONVERTED = ("model/language_model/", "model/vision_tower/", "model/multi_modal_projector/", "model/visual/",
              "model/vision_model/", "model/modality_projection/", "model/text_model/", "model/mm_soft_emb_norm/",
              "model/mm_input_projection", "model/embeddings/", "head/", "head_dense/", "head_norm/", "decoder/",
              "additional_fc/")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _to_tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _leading(tree: Mapping[str, Any]) -> int:
    return next(np.shape(leaf)[0] for leaf in _flatten(tree).values())


def _take(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    return {k: _take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}


def unroll_scanned(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX tree with scanned stacks -> the unrolled layout: ``name/layer``
    (a leading layer axis) becomes ``name_{i}``, and ``name/layer/sub_{j}``
    (a leading period axis over ``P`` layers) ``name_{p * P + j}``; other
    nodes are kept."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif set(value) == {"layer"} and isinstance(value["layer"], Mapping):
            body = value["layer"]
            subs = [f"sub_{j}" for j in range(len(body))]
            if set(body) == set(subs):
                for p in range(_leading(body)):
                    for j, sub in enumerate(subs):
                        out[f"{key}_{p * len(subs) + j}"] = _take(body[sub], p)
            else:
                for i in range(_leading(body)):
                    out[f"{key}_{i}"] = _take(body, i)
        else:
            out[key] = unroll_scanned(value)
    return out


def state_dict_from_jax(params: Mapping[str, Any],
                        quant: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """JAX model params -> state dict. ``params`` is the params tree, or the
    variables ``{"params": ..., "quant": ...}`` (``quant`` optional);
    ``quant``: the ``kernel_scale`` collection of a stored-int8 tree."""
    if set(params) <= {"params", "quant"} and "params" in params:
        params, quant = params["params"], params.get("quant", quant)
    scales = {path[:-1]: leaf for path, leaf in _flatten(unroll_scanned(quant or {})).items()}
    state: Dict[str, torch.Tensor] = {}
    flat = _flatten(unroll_scanned(params))
    for path, leaf in {**flat, **{(*p, "kernel_scale"): v for p, v in scales.items()}}.items():
        joined = "/".join(path)
        if not joined.startswith(_CONVERTED):
            raise ValueError(f"unexpected parameter {joined!r}")
        if "layers" in path or "blocks" in path:
            raise ValueError(f"{joined!r}: a stacked layer tree that is not a scanned stack")
        tensor = _to_tensor(leaf)
        *parts, last = path
        if last == "kernel":
            if tensor.dtype == torch.int8 and tuple(parts) not in scales:
                raise ValueError(f"{joined!r}: an int8 kernel without its quant/kernel_scale")
            tensor, last = tensor.reshape(-1, tensor.shape[-1]).T.contiguous(), "weight"
        elif last == "kernel_scale":
            tensor, last = tensor.reshape(-1).float(), "weight_scale"
        elif last in ("embedding", "scale"):
            last = "weight"
        name = ".".join(re.sub(r"^(layers|blocks)_(\d+)$", r"\1.\2", p) for p in (*parts, last))
        state[name] = tensor
    return state



def lora_from_jax(lora_tree: Mapping[str, Mapping[str, Any]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA tree ``{kernel path: {"a": (in, r), "b": (r, out)}}``
    (``init_lora_params`` or a trained ``state.params``, numpy leaves) ->
    the same mapping with fp32 tensors, which
    :meth:`colpali_tpu_torch.training.lora.LoraAdapters.load_tree` takes.
    Paths and layouts are shared: the port matches adapters by the JAX
    kernel paths and keeps ``a`` and ``b`` in the same orientation."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, adapter in lora_tree.items():
        if set(adapter) != {"a", "b"}:
            raise ValueError(f"{path!r}: expected leaves 'a' and 'b', got {sorted(adapter)}")
        a, b = _to_tensor(adapter["a"]).float(), _to_tensor(adapter["b"]).float()
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError(f"{path!r}: stacked (scanned) adapters are not supported; "
                             "build the JAX model with scan_layers=False")
        out[str(path)] = {"a": a, "b": b}
    return out
