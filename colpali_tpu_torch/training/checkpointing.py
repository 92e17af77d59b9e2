"""Checkpoint save and restore on ``torch.save`` (counterpart of
:mod:`colpali_tpu.training.checkpointing`).

:class:`CheckpointManager` keeps periodic training checkpoints with
retention and restores the latest for ``resume_from_checkpoint``;
:func:`save_pretrained` writes the final export as the JAX package's does:
``model.safetensors`` in the HF torch layout (the family's exporter in
:mod:`colpali_tpu_torch.core.hf_export`, through the port's own safetensors
writer), the model config as JSON (``dataclasses.asdict``, not an HF
config) and a provenance file. Either package's ``load_col*_params`` reads
the weights back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
from typing import Any, Dict, List, Optional

import torch

from colpali_tpu_torch.core import safetensors
from colpali_tpu_torch.core.hf_export import export_for_config


class CheckpointManager:
    """Training checkpoints ``<directory>/step_<n>.pt``.

    :meth:`save` writes when no checkpoint exists yet or ``step`` is a
    multiple of ``save_interval_steps`` (and newer than the latest), then
    drops all but the newest ``max_to_keep``. Saves are synchronous, so
    :meth:`wait` returns at once."""

    def __init__(self, directory: str, save_interval_steps: int = 500, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        found = (re.fullmatch(r"step_(\d+)\.pt", name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """``state`` is anything with ``state_dict()``. Returns whether a
        checkpoint was written."""
        latest = self.latest_step
        if latest is not None and latest >= step:
            return False
        if not (force or latest is None or step % self.save_interval_steps == 0):
            return False
        tmp = self._path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint ``step`` (default: the latest) into ``state``
        (anything with ``load_state_dict``) and return it."""
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        device = next(iter(state.params)).device if getattr(state, "params", None) else "cpu"
        state.load_state_dict(torch.load(self._path(step), map_location=device, weights_only=True))
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


def git_revision(repo_dir: Optional[str] = None) -> str:
    try:
        return subprocess.check_output(["git", "rev-parse", "HEAD"], cwd=repo_dir,
                                       stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


def save_pretrained(output_dir: str, state_dict: Dict[str, torch.Tensor], config: Any = None,
                    extra_metadata: Optional[Dict[str, Any]] = None) -> None:
    """Final export of a model's state dict: ``model.safetensors`` (HF
    names and layouts, the parameters' dtypes), ``config.json`` and
    ``training_provenance.json`` (git hash, ``checkpoint_layout: "hf"``).
    The family follows ``config`` (a ``PaliGemmaConfig``, the default, a
    ``Qwen2VLConfig`` or a ``Qwen25VLConfig``:
    :func:`~colpali_tpu_torch.core.hf_export.export_for_config`)."""
    os.makedirs(output_dir, exist_ok=True)
    safetensors.save_file(export_for_config(state_dict, config), os.path.join(output_dir, "model.safetensors"),
                          metadata={"format": "pt"})
    if config is not None:
        cfg_dict = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(cfg_dict, f, indent=2, default=str)
    provenance = {"git_hash": git_revision(), "checkpoint_layout": "hf", **(extra_metadata or {})}
    with open(os.path.join(output_dir, "training_provenance.json"), "w") as f:
        json.dump(provenance, f, indent=2)
