"""Structured metrics reporting (counterpart of
:mod:`colpali_tpu.utils.reporting`): one JSON object per line in
``<output_dir>/metrics.jsonl``; ``report_to="wandb"`` is honoured when the
package can be imported and downgraded to jsonl otherwise."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional, Union


class MetricsLogger:
    """Append-only metrics sink: jsonl always available, wandb optional.
    Each ``log()`` entry is stamped with wall time, written and flushed at
    once, so a crashed run keeps its history."""

    def __init__(
        self,
        output_dir: str,
        report_to: Union[str, Iterable[str], None] = "jsonl",
        run_name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        sinks = (
            [] if report_to in (None, "none") else
            [report_to] if isinstance(report_to, str) else list(report_to)
        )
        self.history: list = []
        self._file = None
        self._wandb = None
        if "jsonl" in sinks:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, "metrics.jsonl")
            self._file = open(self.path, "a")
        if "wandb" in sinks:
            try:
                import wandb  # optional

                self._wandb = wandb.init(project="colpali-tpu", name=run_name, config=config)
            except ImportError:
                print("report_to=wandb requested but wandb is not installed; using jsonl only")

    def log(self, entry: Dict[str, Any]) -> None:
        entry = {"time": time.time(), **entry}
        self.history.append(entry)
        if self._file is not None:
            self._file.write(json.dumps(entry) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(entry)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
