"""ColQwen2 processor: smart resize, merge-ordered patches and M-RoPE
positions (counterpart of :mod:`colpali_tpu.processors.qwen2_vl`).

- Prompts are the reference ColQwen2Processor's
  (processing_colqwen2.py): ``<|im_start|>user\\n<|vision_start|>
  <|image_pad|><|vision_end|>Describe the image.<|im_end|><|endoftext|>``
  with ``<|image_pad|>`` expanded to the page's merged token count, the
  query augmentation token ``<|endoftext|>``, left padding, and
  ``max_num_visual_tokens * 28 * 28`` as the pixel budget.
- Pages go through HF's ``smart_resize`` (sides multiples of 28, the pixel
  count within the budget) and the exact merge-block patch order of
  image_processing_qwen2_vl.py:54-297, each page's patches padded to the
  batch's longest (a multiple of 4) with ``patch_mask``, ``vision_hpos``
  and ``vision_wpos`` beside them.
- ``position_ids (3, B, S)`` are HF ``get_rope_index``'s
  (modeling_qwen2_vl.py:925-1060), computed in numpy on the host.

The resize is ``jax.image.resize``'s (bicubic, antialiased), in torch on
:attr:`~ColQwen2Processor.device`; ``device_pixels=True`` keeps the
patches there (:func:`_resize_patchify_device`), otherwise the normalized
pixels come back and are patchified on the host. The tokenizer is injected
as for ColPali: ``from_pretrained(path, tokenizer=...)`` or
:func:`~colpali_tpu_torch.processors.base.load_tokenizer`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch, load_tokenizer
from colpali_tpu_torch.processors.image_processing import (
    _resize_normalize,
    host_resize_rgb,
    restore_group_order,
    to_rgb_array,
)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """HF smart_resize (image_processing_qwen2_vl.py:54-80)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(f"absolute aspect ratio must be smaller than 200, got {max(height, width) / min(height, width)}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def patchify(image_chw: np.ndarray, patch_size: int = 14, temporal_patch_size: int = 2,
             merge_size: int = 2) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """A normalized ``(C, H, W)`` image -> merge-ordered patch rows
    ``(grid_t * grid_h * grid_w, C * T * ps * ps)`` and ``(t, h, w)``: the
    frame repeated over the temporal patch, then HF's reshape and
    transpose (image_processing_qwen2_vl.py:270-297)."""
    patches = np.repeat(image_chw[None], temporal_patch_size, axis=0)  # one frame fills the temporal patch
    channel = patches.shape[1]
    grid_t = 1
    grid_h, grid_w = patches.shape[2] // patch_size, patches.shape[3] // patch_size
    patches = patches.reshape(grid_t, temporal_patch_size, channel, grid_h // merge_size, merge_size, patch_size,
                              grid_w // merge_size, merge_size, patch_size)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, channel * temporal_patch_size * patch_size * patch_size)
    return flat, (grid_t, grid_h, grid_w)


def _resize_patchify_device(images_u8: torch.Tensor, mean, std, h1: int, w1: int, patch_size: int,
                            temporal_patch_size: int, merge_size: int) -> torch.Tensor:
    """``(B, H0, W0, 3)`` uint8 -> resize -> normalize -> merge-ordered
    patch rows ``(B, grid_h * grid_w, 3 * T * ps * ps)`` fp32, on the images'
    device: :func:`patchify` over ``_resize_normalize`` without leaving it."""
    x = _resize_normalize(images_u8, mean, std, h1, w1).permute(0, 3, 1, 2)  # (B, C, H, W)
    b = x.shape[0]
    gh, gw = h1 // patch_size, w1 // patch_size
    patches = x[:, None].expand(b, temporal_patch_size, 3, h1, w1)
    patches = patches.reshape(b, 1, temporal_patch_size, 3, gh // merge_size, merge_size, patch_size,
                              gw // merge_size, merge_size, patch_size)
    patches = patches.permute(0, 1, 4, 7, 5, 8, 3, 2, 6, 9)
    return patches.reshape(b, gh * gw, 3 * temporal_patch_size * patch_size * patch_size)


def vision_positions(grid_thw: Tuple[int, int, int], merge_size: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Per-patch (row, column) grid positions in merge-block order (HF
    rot_pos_emb, modeling_qwen2_vl.py:673-701)."""
    t, h, w = grid_thw
    hpos = np.arange(h)[:, None].repeat(w, 1)
    hpos = hpos.reshape(h // merge_size, merge_size, w // merge_size, merge_size).transpose(0, 2, 1, 3).reshape(-1)
    wpos = np.arange(w)[None, :].repeat(h, 0)
    wpos = wpos.reshape(h // merge_size, merge_size, w // merge_size, merge_size).transpose(0, 2, 1, 3).reshape(-1)
    return np.tile(hpos, t), np.tile(wpos, t)


def get_rope_index(input_ids: np.ndarray, attention_mask: np.ndarray, image_grid_thw: Optional[np.ndarray],
                   image_token_id: int, vision_start_token_id: int, spatial_merge_size: int = 2) -> np.ndarray:
    """HF ``Qwen2VLModel.get_rope_index`` in numpy, for images: ``(3, B, S)``
    int64 positions, 1 on padding. Text runs take sequential positions on
    all three channels; an image's merged tokens take (t, row, column)
    offsets after the text before it."""
    b, s = input_ids.shape
    if image_grid_thw is None:
        pos = np.clip(np.cumsum(attention_mask, axis=-1) - 1, 0, None)
        pos = np.where(attention_mask == 0, 1, pos)
        return np.broadcast_to(pos[None], (3, b, s)).astype(np.int64)

    position_ids = np.ones((3, b, s), dtype=np.int64)
    image_index = 0
    for i in range(b):
        ids = input_ids[i][attention_mask[i] == 1]
        tokens = ids.tolist()
        vision_starts = np.nonzero(ids == vision_start_token_id)[0]
        image_nums = int((ids[vision_starts + 1] == image_token_id).sum()) if vision_starts.size else 0
        chunks: List[np.ndarray] = []
        st = 0
        for _ in range(image_nums):
            ed = tokens.index(image_token_id, st)
            gt, h, w = (int(x) for x in image_grid_thw[image_index])
            image_index += 1
            gh, gw = h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            st_idx = chunks[-1].max() + 1 if chunks else 0
            chunks.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
            t_index = np.arange(gt)[:, None].repeat(gh * gw, 1).reshape(-1)
            h_index = np.arange(gh)[None, :, None].repeat(gt, 0).repeat(gw, 2).reshape(-1)
            w_index = np.arange(gw)[None, None, :].repeat(gt, 0).repeat(gh, 1).reshape(-1)
            chunks.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
            st = ed + gt * gh * gw
        if st < len(tokens):
            st_idx = chunks[-1].max() + 1 if chunks else 0
            text_len = len(tokens) - st
            chunks.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        position_ids[:, i, attention_mask[i] == 1] = np.concatenate(chunks, axis=1)
    return position_ids


class ColQwen2Processor(BaseVisualRetrieverProcessor):
    visual_prompt_prefix: str = (
        "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>Describe the image.<|im_end|><|endoftext|>"
    )
    query_augmentation_token: str = "<|endoftext|>"
    image_token: str = "<|image_pad|>"
    vision_start_token: str = "<|vision_start|>"

    def __init__(
        self,
        tokenizer: Any,
        patch_size: int = 14,
        merge_size: int = 2,
        temporal_patch_size: int = 2,
        min_pixels: int = 56 * 56,
        max_pixels: int = 14 * 14 * 4 * 1280,
        max_num_visual_tokens: Optional[int] = None,
        image_mean: Sequence[float] = CLIP_MEAN,
        image_std: Sequence[float] = CLIP_STD,
        device: Union[str, torch.device] = "cuda",
    ):
        """``max_num_visual_tokens`` sets the pixel budget to that many
        merged 28 x 28 tokens (the reference's from_pretrained); ``device``:
        where :meth:`process_images` resizes."""
        self.tokenizer = tokenizer
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.temporal_patch_size = temporal_patch_size
        self.min_pixels = min_pixels
        self.max_pixels = (max_num_visual_tokens * (patch_size * merge_size) ** 2
                           if max_num_visual_tokens is not None else max_pixels)
        self.image_mean = tuple(float(np.float32(x)) for x in image_mean)  # fp32 values, as JAX keeps and writes them
        self.image_std = tuple(float(np.float32(x)) for x in image_std)
        self.device = torch.device(device)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.image_token)
        self.vision_start_token_id = tokenizer.convert_tokens_to_ids(self.vision_start_token)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "ColQwen2Processor":
        """A processor for the checkpoint directory ``path``: the patch
        geometry, pixel bounds, mean and std of its
        ``preprocessor_config.json``, then ``kwargs`` over those. The
        tokenizer is ``kwargs["tokenizer"]`` or :func:`load_tokenizer` on
        ``path``."""
        tokenizer = kwargs.pop("tokenizer", None) or load_tokenizer(path)
        init_kwargs = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
            for key in ("patch_size", "merge_size", "temporal_patch_size", "min_pixels", "max_pixels"):
                if key in pp:
                    init_kwargs[key] = pp[key]
            size = pp.get("size", {})
            init_kwargs["min_pixels"] = size.get("shortest_edge", init_kwargs.get("min_pixels", 56 * 56))
            init_kwargs["max_pixels"] = size.get("longest_edge", init_kwargs.get("max_pixels"))
            init_kwargs["image_mean"] = pp.get("image_mean", CLIP_MEAN)
            init_kwargs["image_std"] = pp.get("image_std", CLIP_STD)
        init_kwargs.update(kwargs)
        return cls(tokenizer, **init_kwargs)

    def _export_configs(self) -> tuple:
        pp = {
            "patch_size": self.patch_size,
            "merge_size": self.merge_size,
            "temporal_patch_size": self.temporal_patch_size,
            "min_pixels": self.min_pixels,
            "max_pixels": self.max_pixels,
            "size": {"shortest_edge": self.min_pixels, "longest_edge": self.max_pixels},
            "image_mean": list(self.image_mean),
            "image_std": list(self.image_std),
        }
        return pp, {}

    # --- pages ---------------------------------------------------------

    def _target(self, height: int, width: int) -> Tuple[int, int]:
        return smart_resize(height, width, self.patch_size * self.merge_size, self.min_pixels, self.max_pixels)

    def _group_by_shape(self, images: Sequence[Any], host_resize: bool = False):
        """RGB arrays of the pages (with ``host_resize``, resized on the host
        to their targets first) and the groups of pages sharing a source
        shape and a target: ``{(shape, (h1, w1)): [indices]}``."""
        if host_resize:
            arrays = []
            for im in images:
                h0, w0 = (im.size[1], im.size[0]) if hasattr(im, "convert") else np.asarray(im).shape[:2]
                arrays.append(host_resize_rgb(im, self._target(h0, w0)))
        else:
            arrays = [to_rgb_array(im) for im in images]
        groups: dict = {}
        for i, a in enumerate(arrays):
            groups.setdefault((a.shape[:2], self._target(*a.shape[:2])), []).append(i)
        return arrays, groups

    def _preprocess_many(self, images: Sequence[Any]) -> Tuple[List[np.ndarray], List[Tuple[int, int, int]]]:
        """Resize and normalize on :attr:`device` (one batch a shape group),
        then patchify each page on the host."""
        arrays, groups = self._group_by_shape(images)
        normed: List[Optional[np.ndarray]] = [None] * len(arrays)
        for (_, (h1, w1)), idxs in groups.items():
            batch = torch.from_numpy(np.stack([arrays[i] for i in idxs])).to(self.device)
            out = _resize_normalize(batch, self.image_mean, self.image_std, h1, w1).cpu().numpy()
            for j, i in enumerate(idxs):
                normed[i] = out[j]
        flats, grids = [], []
        for norm in normed:
            flat, grid = patchify(norm.transpose(2, 0, 1), self.patch_size, self.temporal_patch_size,
                                  self.merge_size)
            flats.append(flat)
            grids.append(grid)
        return flats, grids

    def _preprocess_many_device(self, images: Sequence[Any], host_resize: bool = False):
        """Resize, normalize and patchify on :attr:`device`, one batch a shape
        group -> the padded ``(B, p_max, patch_dim)`` fp32 patches there and
        the grids."""
        arrays, groups = self._group_by_shape(images, host_resize=host_resize)
        grids: List[Optional[Tuple[int, int, int]]] = [None] * len(arrays)
        flat_groups, idx_groups = [], []
        for (_, (h1, w1)), idxs in groups.items():
            batch = torch.from_numpy(np.stack([arrays[i] for i in idxs])).to(self.device)
            flat_groups.append(_resize_patchify_device(batch, self.image_mean, self.image_std, h1, w1,
                                                       self.patch_size, self.temporal_patch_size, self.merge_size))
            for i in idxs:
                grids[i] = (1, h1 // self.patch_size, w1 // self.patch_size)
            idx_groups.append(idxs)
        group = self.merge_size**2
        p_max = -(-max(f.shape[1] for f in flat_groups) // group) * group
        padded = [torch.nn.functional.pad(f, (0, 0, 0, p_max - f.shape[1])) for f in flat_groups]
        return restore_group_order(padded, idx_groups), grids

    def _tokenize(self, texts: Sequence[str]) -> Batch:
        enc = self.tokenizer(list(texts), padding="longest", padding_side="left", add_special_tokens=False,
                             return_tensors="np")
        return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}

    def process_images(self, images: Sequence[Any], context_prompts: Optional[Sequence[str]] = None,
                       device_pixels: bool = False, host_resize: bool = False) -> Batch:
        """Pages -> ids, mask, ``pixel_values (B, P, 1176)`` fp32 patches,
        ``patch_mask``, ``vision_hpos``, ``vision_wpos`` ``(B, P)``,
        ``image_grid_thw (B, 3)`` and ``position_ids (3, B, S)``.
        ``device_pixels=True``: the patches are made and stay on
        :attr:`device` (a tensor); otherwise numpy. ``host_resize=True``
        (with ``device_pixels``): resized with PIL on the host first."""
        prompts = list(context_prompts) if context_prompts else [self.visual_prompt_prefix] * len(images)
        if len(prompts) != len(images):
            raise ValueError(f"Got {len(images)} images but {len(prompts)} prompts")
        if device_pixels:
            device_patches, grids = self._preprocess_many_device(images, host_resize=host_resize)
            p_max = device_patches.shape[1]
        else:
            flats, grids = self._preprocess_many(images)
            group = self.merge_size**2
            p_max = -(-max(f.shape[0] for f in flats) // group) * group

        texts = [prompt.replace(self.image_token, self.image_token * (t * (h // self.merge_size)
                                                                      * (w // self.merge_size)))
                 for prompt, (t, h, w) in zip(prompts, grids)]
        batch = self._tokenize(texts)

        b = len(grids)
        patch_mask = np.zeros((b, p_max), bool)
        hpos = np.zeros((b, p_max), np.int32)
        wpos = np.zeros((b, p_max), np.int32)
        if not device_pixels:
            pixel_values = np.zeros((b, p_max, flats[0].shape[1]), np.float32)
        for i, grid in enumerate(grids):
            n = grid[0] * grid[1] * grid[2]
            if not device_pixels:
                pixel_values[i, :n] = flats[i]
            patch_mask[i, :n] = True
            hpos[i, :n], wpos[i, :n] = vision_positions(grid, self.merge_size)
        batch["pixel_values"] = device_patches if device_pixels else pixel_values
        batch["patch_mask"] = patch_mask
        batch["vision_hpos"] = hpos
        batch["vision_wpos"] = wpos
        batch["image_grid_thw"] = np.asarray(grids, np.int64)
        batch["position_ids"] = get_rope_index(batch["input_ids"], batch["attention_mask"], batch["image_grid_thw"],
                                               self.image_token_id, self.vision_start_token_id, self.merge_size)
        return batch

    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Texts and queries: left-padded ids and mask, and text positions."""
        batch = self._tokenize(texts)
        batch["position_ids"] = get_rope_index(batch["input_ids"], batch["attention_mask"], None,
                                               self.image_token_id, self.vision_start_token_id)
        return batch

    def get_n_patches(self, image_size: Tuple[int, int], spatial_merge_size: Optional[int] = None) -> Tuple[int, int]:
        """The merged-token grid ``(n_x, n_y)`` of a page. As the reference
        does (processing_colqwen2.py:141-147), ``image_size[0]`` is taken as
        the width and ``image_size[1]`` as the height."""
        merge = spatial_merge_size or self.merge_size
        width, height = image_size[0], image_size[1]
        h_new, w_new = self._target(height, width)
        return w_new // self.patch_size // merge, h_new // self.patch_size // merge

    def get_image_mask(self, batch: Batch) -> np.ndarray:
        return batch["input_ids"] == self.image_token_id
