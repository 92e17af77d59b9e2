"""YAML config system (counterpart of :mod:`colpali_tpu.configs`): a YAML
mapping in which any dict with a ``_target_`` key is instantiated from its
dotted import path, depth-first.

Example:

```yaml
config:
  model:
    _target_: colpali_tpu_torch.models.paligemma.ColPali
    config: {_target_: colpali_tpu_torch.models.configs.PaliGemmaConfig}
    dim: 128
    dtype: {_target_: colpali_tpu_torch.configs.bfloat16}
    remat: true
  loss_func: {_target_: colpali_tpu_torch.losses.ColbertPairwiseCELoss}
  peft: {_target_: colpali_tpu_torch.training.LoraSpec, rank: 32, alpha: 32, dropout: 0.1}
  global_batch_size: 8
```
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

TARGET_KEY = "_target_"

# the training recipes under ``configs/`` name the JAX package's classes; the port reads ``colpali_tpu.X`` as
# ``colpali_tpu_torch.X``
JAX_PACKAGE, PORT_PACKAGE = "colpali_tpu.", "colpali_tpu_torch."
# options of the JAX package's models that the port has no counterpart of: ``scan_layers`` stacks the layers under
# ``nn.scan`` for XLA's compile time; the port runs its layers in a Python loop
JAX_ONLY_OPTIONS = ("scan_layers",)


def _resolve(path: str) -> Any:
    if path.startswith(JAX_PACKAGE):
        path = PORT_PACKAGE + path[len(JAX_PACKAGE):]
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ must be a dotted path, got: {path}")
    try:
        return getattr(importlib.import_module(module_name), attr)
    except ModuleNotFoundError:
        # a classmethod or attribute of a class: pkg.module.Class.method
        owner_name, _, owner_attr = module_name.rpartition(".")
        return getattr(getattr(importlib.import_module(owner_name), owner_attr), attr)


def instantiate(node: Any) -> Any:
    """Depth-first instantiation of ``_target_`` nodes, a ``colpali_tpu.``
    target read as the port's and :data:`JAX_ONLY_OPTIONS` dropped. A node
    that is neither a dict nor a list (a built object) is taken as it is."""
    if isinstance(node, dict):
        materialized = {k: instantiate(v) for k, v in node.items() if k != TARGET_KEY and k not in JAX_ONLY_OPTIONS}
        if TARGET_KEY in node:
            return _resolve(node[TARGET_KEY])(**materialized)
        return materialized
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def load_config(path: str, sub_path: str = "config") -> Dict[str, Any]:
    """Load a YAML file and instantiate its ``sub_path`` subtree (needs
    ``pyyaml``, imported here only)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    node = raw[sub_path] if sub_path and sub_path in raw else raw
    return instantiate(node)


def bfloat16():
    """A dtype handle configs can name through ``_target_``."""
    import torch

    return torch.bfloat16
