"""ColIdefics3 (ColSmol) processor: image splitting and split-image prompts
(counterpart of :mod:`colpali_tpu.processors.idefics3`).

- Prompts are the reference ColIdefics3Processor's
  (processing_colidefics3.py): ``<|im_start|>User:<image prompt>Describe
  the image.<end_of_utterance>\\nAssistant:``, the image prompt with HF's
  ``<fake_token_around_image>`` / ``<row_r_col_c>`` / ``<global-img>``
  markers around ``image_seq_len`` ``<image>`` tokens a tile
  (processing_idefics3.py:46-87). Queries are tokenized raw with the
  ``<end_of_utterance>`` x 10 augmentation suffix. Ids pad on the right.
- A page whose longest edge exceeds ``longest_edge`` is resized to it (even
  sides), split into a ceil grid of crops each resized to ``tile_size``
  square, and followed by the whole page resized to one more tile: ``(B,
  T, S, S, 3)`` normalized tiles, zero-padded over T, with ``tile_mask``.
  As in JAX every tile is a full square (no ragged crops).

Every resize is ``jax.image.resize``'s (bicubic, antialiased) as two fp32
products with the per-axis weights, in torch on :attr:`device`, one batch
a group of pages that share a source shape and a target:
``device_pixels=True`` keeps the tiles there (:meth:`_split_many_device`),
otherwise they come back as numpy (:meth:`_split_many`). The tokenizer is
injected as for the other families: ``from_pretrained(path, tokenizer=...)``
or :func:`~colpali_tpu_torch.processors.base.load_tokenizer`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch, load_tokenizer
from colpali_tpu_torch.processors.image_processing import (
    host_resize_rgb,
    normalize_pixels,
    resize_float,
    restore_group_order,
    to_rgb_array,
)


def resized_dimensions(height: int, width: int, longest_edge: Optional[int]) -> Tuple[int, int]:
    """Longest-edge resize with even dims (reference
    Idefics3SplitImageInterpretabilityMixin._calculate_resized_dimensions,
    processing_utils.py:338-383)."""
    if longest_edge is None:
        return height, width
    aspect_ratio = width / height
    if width >= height:
        width_new = longest_edge
        height_new = int(width_new / aspect_ratio)
        height_new += height_new % 2
    else:
        height_new = longest_edge
        width_new = int(height_new * aspect_ratio)
        width_new += width_new % 2
    return max(height_new, 1), max(width_new, 1)


def crop_bounds(h1: int, w1: int, s: int) -> Tuple[int, int, List[Tuple[int, int, int, int]]]:
    """``(rows, cols, [(r0, r1, c0, c1)])`` of a page resized to ``h1 x w1``:
    the ceil grid of crops of ``ceil(h1 / rows) x ceil(w1 / cols)`` (the last
    ones cut at the edge) when a side exceeds the tile ``s``, then the whole
    page (the global view); rows = cols = 0 and the global view alone
    otherwise."""
    bounds = []
    rows = cols = 0
    if h1 > s or w1 > s:
        rows, cols = math.ceil(h1 / s), math.ceil(w1 / s)
        opt_h, opt_w = math.ceil(h1 / rows), math.ceil(w1 / cols)
        for r in range(rows):
            for c in range(cols):
                bounds.append((r * opt_h, min((r + 1) * opt_h, h1), c * opt_w, min((c + 1) * opt_w, w1)))
    bounds.append((0, h1, 0, w1))
    return rows, cols, bounds


def split_resize_normalize(batch_u8: torch.Tensor, mean, std, h1: int, w1: int, s: int) -> torch.Tensor:
    """``(B, H0, W0, 3)`` uint8 pages of one shape -> ``(B, T, s, s, 3)``
    fp32 normalized tiles on their device: the longest-edge resize to ``h1 x
    w1`` on 0..255 floats, each crop of :func:`crop_bounds` resized to ``s``
    square, the global view last, then ``(x / 255 - mean) / std``."""
    x = resize_float(batch_u8.float(), h1, w1)
    _, _, bounds = crop_bounds(h1, w1, s)
    tiles = [resize_float(x[:, r0:r1, c0:c1], s, s) for r0, r1, c0, c1 in bounds]
    return normalize_pixels(torch.stack(tiles, dim=1), mean, std)


class ColIdefics3Processor(BaseVisualRetrieverProcessor):
    image_token: str = "<image>"
    fake_image_token: str = "<fake_token_around_image>"
    global_img_token: str = "<global-img>"
    prompt_prefix: str = "<|im_start|>User:"
    prompt_suffix: str = "<end_of_utterance>\nAssistant:"
    query_augmentation_token: str = "<end_of_utterance>"  # reference processing_colidefics3.py:23

    def __init__(
        self,
        tokenizer: Any,
        tile_size: int = 512,
        longest_edge: int = 2048,
        image_seq_len: int = 64,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
        device: Union[str, torch.device] = "cuda",
    ):
        """``device``: where :meth:`process_images` resizes and splits."""
        self.tokenizer = tokenizer
        self.tile_size = tile_size
        self.longest_edge = longest_edge
        self.image_seq_len = image_seq_len
        self.image_mean = tuple(float(np.float32(x)) for x in image_mean)  # fp32 values, as JAX keeps them
        self.image_std = tuple(float(np.float32(x)) for x in image_std)
        self.device = torch.device(device)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.image_token)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "ColIdefics3Processor":
        """A processor for the checkpoint directory ``path``: the tile size,
        longest edge, mean and std of its ``preprocessor_config.json``, the
        ``image_seq_len`` of its ``processor_config.json``, then ``kwargs``
        over those. The tokenizer is ``kwargs["tokenizer"]`` or
        :func:`load_tokenizer` on ``path``."""
        tokenizer = kwargs.pop("tokenizer", None) or load_tokenizer(path)
        init_kwargs: Dict[str, Any] = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
            init_kwargs["tile_size"] = pp.get("max_image_size", {}).get("longest_edge", 512)
            init_kwargs["longest_edge"] = pp.get("size", {}).get("longest_edge", 2048)
            init_kwargs["image_mean"] = pp.get("image_mean", (0.5, 0.5, 0.5))
            init_kwargs["image_std"] = pp.get("image_std", (0.5, 0.5, 0.5))
        proc_path = os.path.join(path, "processor_config.json")
        if os.path.exists(proc_path):
            with open(proc_path) as f:
                init_kwargs["image_seq_len"] = json.load(f).get("image_seq_len", 64)
        init_kwargs.update(kwargs)
        return cls(tokenizer, **init_kwargs)

    def _export_configs(self) -> tuple:
        pp = {
            "max_image_size": {"longest_edge": self.tile_size},
            "size": {"longest_edge": self.longest_edge},
            "image_mean": list(self.image_mean),
            "image_std": list(self.image_std),
        }
        return pp, {"image_seq_len": self.image_seq_len}

    # --- pages ---------------------------------------------------------

    def _target(self, height: int, width: int) -> Tuple[int, int]:
        return resized_dimensions(height, width, self.longest_edge if max(height, width) > self.longest_edge else None)

    def _split_groups(self, images: Sequence[Any]):
        """Each group of pages sharing a source shape and a target, split on
        :attr:`device`: ``[(indices, (B, T, s, s, 3) tiles, rows, cols)]``."""
        arrays = [to_rgb_array(im) for im in images]  # uint8 up: a quarter of fp32's bytes
        groups: Dict[tuple, List[int]] = {}
        for i, a in enumerate(arrays):
            groups.setdefault((a.shape[:2], self._target(*a.shape[:2])), []).append(i)
        out = []
        for (_, (h1, w1)), idxs in groups.items():
            batch = torch.from_numpy(np.stack([arrays[i] for i in idxs])).to(self.device)
            rows, cols, _ = crop_bounds(h1, w1, self.tile_size)
            out.append((idxs, split_resize_normalize(batch, self.image_mean, self.image_std, h1, w1, self.tile_size),
                        rows, cols))
        return out

    def _split_many(self, images: Sequence[Any]) -> List[Tuple[np.ndarray, int, int]]:
        """Per page ``(tiles (T, S, S, 3) fp32 numpy with the global tile
        last, rows, cols)``."""
        out: List[Optional[Tuple[np.ndarray, int, int]]] = [None] * len(images)
        for idxs, tiles, rows, cols in self._split_groups(images):
            host = tiles.cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = (host[j], rows, cols)
        return out

    def _split_many_device(self, images: Sequence[Any]):
        """The padded ``(B, T_max, S, S, 3)`` tile batch on :attr:`device`,
        the tile counts and ``[(rows, cols)]`` per page."""
        parts = self._split_groups(images)
        t_max = max(tiles.shape[1] for _, tiles, _, _ in parts)
        padded = [torch.nn.functional.pad(tiles, (0, 0, 0, 0, 0, 0, 0, t_max - tiles.shape[1]))
                  for _, tiles, _, _ in parts]
        layouts: List[Tuple[int, int]] = [(0, 0)] * len(images)
        for idxs, _, rows, cols in parts:
            for i in idxs:
                layouts[i] = (rows, cols)
        stacked = restore_group_order(padded, [idxs for idxs, _, _, _ in parts])
        return stacked, [r * c + 1 for r, c in layouts], layouts

    def _image_prompt(self, rows: int, cols: int) -> str:
        """HF get_image_prompt_string (processing_idefics3.py:46-87)."""
        img = self.image_token * self.image_seq_len
        if rows == 0 and cols == 0:
            return f"{self.fake_image_token}{self.global_img_token}{img}{self.fake_image_token}"
        text = ""
        for r in range(rows):
            for c in range(cols):
                text += f"{self.fake_image_token}<row_{r + 1}_col_{c + 1}>{img}"
            text += "\n"
        text += f"\n{self.fake_image_token}{self.global_img_token}{img}{self.fake_image_token}"
        return text

    def _tokenize(self, texts: Sequence[str]) -> Batch:
        enc = self.tokenizer(list(texts), padding="longest", padding_side="right", add_special_tokens=False,
                             return_tensors="np")
        return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}

    def process_images(self, images: Sequence[Any], context_prompts: Optional[Sequence[str]] = None,
                       device_pixels: bool = False, host_resize: bool = False) -> Batch:
        """Pages -> right-padded ids and mask, ``pixel_values (B, T, S, S,
        3)`` fp32 tiles and ``tile_mask (B, T)``. ``device_pixels=True``: the
        tiles stay on :attr:`device` (a tensor); otherwise numpy.
        ``host_resize=True``: a page over ``longest_edge`` is resized with PIL
        bicubic on the host first (fewer bytes up); the tiles are cut on the
        device either way."""
        if host_resize:
            images = [host_resize_rgb(im, self._target(*to_rgb_array(im).shape[:2])) for im in images]
        if device_pixels:
            tiles, counts, rc = self._split_many_device(images)
            layouts = [(counts[i], *rc[i]) for i in range(len(images))]
        else:
            split = self._split_many(images)
            layouts = [(t.shape[0], rows, cols) for t, rows, cols in split]
        user_prompts = list(context_prompts) if context_prompts else ["Describe the image."] * len(images)
        batch = self._tokenize([f"{self.prompt_prefix}{self._image_prompt(rows, cols)}{user}{self.prompt_suffix}"
                                for (_, rows, cols), user in zip(layouts, user_prompts)])
        t_max = tiles.shape[1] if device_pixels else max(n for n, _, _ in layouts)
        tile_mask = np.zeros((len(images), t_max), bool)
        for i, (n_tiles, _, _) in enumerate(layouts):
            tile_mask[i, :n_tiles] = True
        if not device_pixels:
            s = self.tile_size
            tiles = np.zeros((len(images), t_max, s, s, 3), np.float32)
            for i, (t, _, _) in enumerate(split):
                tiles[i, : t.shape[0]] = t
        batch["pixel_values"] = tiles
        batch["tile_mask"] = tile_mask
        return batch

    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Raw tokenization, right-padded: the reference applies no query
        wrapper (processing_colidefics3.py:64-78)."""
        return self._tokenize(list(texts))

    def get_n_patches(self, image_size: Tuple[int, int], patch_size: Optional[int] = None) -> Tuple[int, int]:
        """Token grid of the local tiles, ceil(resized / tile) x tokens a side
        (reference processing_colidefics3.py:92-126)."""
        h, w = image_size
        h1, w1 = self._target(h, w)
        side = int(math.sqrt(self.image_seq_len))
        if h1 > self.tile_size or w1 > self.tile_size:
            rows, cols = math.ceil(h1 / self.tile_size), math.ceil(w1 / self.tile_size)
        else:
            rows = cols = 1
        return cols * side, rows * side

    def get_image_mask(self, batch: Batch) -> np.ndarray:
        return np.asarray(batch["input_ids"]) == self.image_token_id

    def get_local_image_mask(self, batch: Batch) -> np.ndarray:
        """The image-token mask without the global tile (each row's last
        ``image_seq_len`` image tokens; reference processing_utils.py:299-336);
        a single-tile page keeps its global view as its map."""
        full = self.get_image_mask(batch)
        local = full.copy()
        for i in range(full.shape[0]):
            positions = np.nonzero(full[i])[0]
            if positions.size > self.image_seq_len:
                local[i, positions[-self.image_seq_len:]] = False
        return local
