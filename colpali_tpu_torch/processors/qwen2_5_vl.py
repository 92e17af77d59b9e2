"""ColQwen2_5 processor: ColQwen2's prompting and pages, plus the
per-patch window ids of Qwen2.5-VL's window attention (counterpart of
:mod:`colpali_tpu.processors.qwen2_5_vl`).

HF's get_window_index (modeling_qwen2_5_vl.py:365-400) groups merged units
into ``window_size / merge / patch`` squares (edge windows cut short); the
ids are computed here from the merge-ordered grid positions, -1 on padding.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np

from colpali_tpu_torch.processors.base import Batch
from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor


def window_ids_from_positions(hpos: np.ndarray, wpos: np.ndarray, grid_thw: tuple, merge_size: int,
                              window_patches: int) -> np.ndarray:
    """Per-patch window id (merge order): merged units grouped into
    ``window_patches`` x ``window_patches`` tiles, per temporal frame."""
    t, h, w = grid_thw
    mh, mw = hpos // merge_size, wpos // merge_size
    num_w = -(-(w // merge_size) // window_patches)
    num_h = -(-(h // merge_size) // window_patches)
    win = (mh // window_patches) * num_w + (mw // window_patches)
    frame = np.arange(hpos.shape[0]) // (h * w)  # windows never span frames
    return (win + frame * num_h * num_w).astype(np.int32)


class ColQwen2_5Processor(ColQwen2Processor):  # noqa: N801 (the reference's name)
    """ColQwen2's processor; pages also carry ``window_id (B, P)``."""

    def __init__(self, *args, window_size: int = 112, **kwargs):
        super().__init__(*args, **kwargs)
        self.window_size = window_size

    @property
    def _window_patches(self) -> int:
        return self.window_size // self.merge_size // self.patch_size

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "ColQwen2_5Processor":
        """ColQwen2's, and the vision ``window_size`` of the checkpoint's
        ``config.json``: the ids must cut windows as its tower does."""
        if "window_size" not in kwargs:
            cfg_path = os.path.join(path, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
                vision_cfg = cfg.get("vision_config") or cfg.get("vision") or {}  # HF's, or the training export's
                if "window_size" in vision_cfg:
                    kwargs["window_size"] = vision_cfg["window_size"]
        return super().from_pretrained(path, **kwargs)

    def process_images(self, images: Sequence[Any], context_prompts=None, device_pixels: bool = False,
                       host_resize: bool = False) -> Batch:
        batch = super().process_images(images, context_prompts, device_pixels=device_pixels, host_resize=host_resize)
        b, p = batch["patch_mask"].shape
        window_id = np.full((b, p), -1, np.int32)
        for i in range(b):
            n = int(batch["patch_mask"][i].sum())
            grid = tuple(int(x) for x in batch["image_grid_thw"][i])
            window_id[i, :n] = window_ids_from_positions(batch["vision_hpos"][i, :n], batch["vision_wpos"][i, :n],
                                                         grid, self.merge_size, self._window_patches)
        batch["window_id"] = window_id
        return batch


ColQwen2_5_Processor = ColQwen2_5Processor  # the reference's other name (processing_colqwen2_5.py)
