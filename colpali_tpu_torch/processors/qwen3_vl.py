"""ColQwen3 processor: ColQwen2's pipeline at Qwen3-VL's geometry, plus the
bilinear taps into the vision tower's learned position table (counterpart
of :mod:`colpali_tpu.processors.qwen3_vl`).

The resize factor is ``patch_size * merge_size`` (32 for Qwen3-VL's 16 px
patches; reference processing_colqwen3.py:59-66), so
``max_num_visual_tokens`` bounds the pixels at that many 32 x 32 merged
tokens. Pages also carry ``pos_idx (B, P, 4)`` int32 and ``pos_weight (B,
P, 4)`` float32 (:func:`~colpali_tpu_torch.models.qwen3_vl.pos_embed_interp_indices`
of each page's grid; zero past its patches).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence

import numpy as np

from colpali_tpu_torch.models.qwen3_vl import pos_embed_interp_indices
from colpali_tpu_torch.processors.base import Batch
from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor


class ColQwen3Processor(ColQwen2Processor):
    """ColQwen2's processor at 16 px patches; pages also carry the position
    table's taps for a table of ``num_grid_per_side``^2 entries."""

    def __init__(self, tokenizer: Any, patch_size: int = 16, merge_size: int = 2, num_grid_per_side: int = 48,
                 min_pixels: int = 65536, max_pixels: int = 16777216, **kwargs):
        super().__init__(tokenizer, patch_size=patch_size, merge_size=merge_size, min_pixels=min_pixels,
                         max_pixels=max_pixels, **kwargs)
        self.num_grid_per_side = num_grid_per_side

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "ColQwen3Processor":
        """ColQwen2's, and the grid side of the checkpoint's position table
        (``num_position_embeddings`` of its ``config.json``): the taps must
        index the table the checkpoint ships."""
        if "num_grid_per_side" not in kwargs:
            cfg_path = os.path.join(path, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
                vision_cfg = cfg.get("vision_config") or cfg.get("vision") or {}  # HF's, or the training export's
                if "num_position_embeddings" in vision_cfg:
                    kwargs["num_grid_per_side"] = int(vision_cfg["num_position_embeddings"] ** 0.5)
        return super().from_pretrained(path, **kwargs)

    def process_images(self, images: Sequence[Any], context_prompts: Optional[Sequence[str]] = None,
                       device_pixels: bool = False, host_resize: bool = False) -> Batch:
        batch = super().process_images(images, context_prompts, device_pixels=device_pixels, host_resize=host_resize)
        b, p = batch["patch_mask"].shape
        pos_idx = np.zeros((b, p, 4), np.int32)
        pos_weight = np.zeros((b, p, 4), np.float32)
        for i in range(b):
            n = int(batch["patch_mask"][i].sum())
            grid = tuple(int(x) for x in batch["image_grid_thw"][i])
            pos_idx[i, :n], pos_weight[i, :n] = pos_embed_interp_indices(grid, self.num_grid_per_side,
                                                                         self.merge_size)
        batch["pos_idx"] = pos_idx
        batch["pos_weight"] = pos_weight
        return batch


class ColQwen3_5Processor(ColQwen3Processor):  # noqa: N801 (the reference's name)
    """The Qwen3.5 retriever's processor (reference
    processing_colqwen3_5.py:12-121): ColQwen3's pipeline unchanged, the
    Qwen3.5 backbone reusing Qwen3-VL's vision tower and geometry."""
