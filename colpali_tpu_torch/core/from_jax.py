"""Carry a JAX ColPali parameter tree over to the port's state dict.

The JAX package's ``ColPali`` params (a nested dict with numpy leaves, as
``jax.tree.map(np.asarray, variables)`` gives them) become the state dict of
:class:`colpali_tpu_torch.models.paligemma.ColPali`:

- flax ``Dense`` kernels ``(in, out)`` become ``nn.Linear`` weights ``(out, in)``;
- ``embed_tokens/embedding`` becomes ``embed_tokens.weight``;
- unrolled ``layers_{i}`` become ``layers.{i}``.

Only ``model/language_model/*`` and ``head/*`` are converted; the subtrees
of the document-embedding slice (the vision tower and the projector) are
skipped and their names returned. bf16 leaves (``ml_dtypes.bfloat16``) are
taken bit for bit.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

SKIPPED_SUBTREES = ("model/vision_tower", "model/multi_modal_projector")
_CONVERTED = ("model/language_model/", "head/")


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


def colpali_state_dict_from_jax(params: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX ColPali params (with or without the top ``"params"`` level) ->
    ``(state_dict, skipped subtree names)``."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    skipped = set()
    for path, leaf in _flatten(params).items():
        joined = "/".join(path)
        top = next((s for s in SKIPPED_SUBTREES if joined.startswith(s + "/")), None)
        if top is not None:
            skipped.add(top)
            continue
        if not joined.startswith(_CONVERTED):
            raise ValueError(f"unexpected ColPali parameter {joined!r}")
        if "layers" in path:
            raise ValueError(f"{joined!r}: scanned (stacked) layers are not supported; "
                             "build the JAX model with scan_layers=False")
        tensor = _to_tensor(leaf)
        *parts, last = path
        if last == "kernel":
            tensor, last = tensor.T.contiguous(), "weight"
        elif last == "embedding":
            last = "weight"
        name = ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in (*parts, last))
        state[name] = tensor
    return state, sorted(skipped)
