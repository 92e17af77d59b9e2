"""Training collator: example dicts -> prefixed model input batches
(counterpart of :mod:`colpali_tpu.data.collator`).

One query and one positive are sampled per example, queries get the
processor's query prefix and 10 augmentation tokens, text and image payloads
are told apart, the three sub-batches are key-prefixed (``query_`` /
``doc_`` / ``neg_doc_``) and explicit negatives are reshaped to
``(B, n_neg, ...)``.

Optional fixed padding targets give every batch the same shapes. Each is an
int or a sorted list of bucket sizes (the smallest bucket that fits wins):
``pad_seq_to`` for the token axes (input_ids / attention_mask /
position_ids), ``pad_patches_to`` for the visual patch axis of
dynamic-resolution families (``pixel_values (B, P, D)`` with patch_mask /
vision_hpos / vision_wpos, Qwen2.5-VL's window_id, padded with the
processor's pad id -1, and Qwen3-VL's position-table taps ``pos_idx`` /
``pos_weight (B, P, 4)``, padded with 0 along their patch axis: the JAX
package leaves window_id, pos_idx and pos_weight unpadded, which hands the
tower arrays of the wrong length). Values may be numpy arrays or tensors (a
processor that stages pixels on the device returns tensors); tensors are
padded with ``torch``, where they are.
"""

from __future__ import annotations

import inspect
import random
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from colpali_tpu_torch.data.dataset import ColPaliEngineDataset
from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor

N_AUGMENTATION_TOKENS = 10

PadSpec = Union[int, Sequence[int]]


def prefix_keys(data: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {f"{prefix}{k}": v for k, v in data.items()}


def pick_bucket(current: int, spec: PadSpec, multiple: int = 1) -> int:
    """Smallest configured bucket >= current (rounded up to ``multiple``).
    A bare int is a single bucket. Overflow is an error: silent truncation
    would corrupt training."""
    buckets = [spec] if isinstance(spec, int) else sorted(spec)
    for b in buckets:
        b = ((b + multiple - 1) // multiple) * multiple
        if b >= current:
            return b
    raise ValueError(
        f"Batch needs {current} elements but the largest pad bucket is "
        f"{buckets[-1]}; add a bigger bucket (buckets={buckets})"
    )


def _pad_axis(value: Any, axis: int, target: int, fill: int = 0) -> Any:
    cur = value.shape[axis]
    if cur >= target:
        return value
    if isinstance(value, np.ndarray):
        pad = [(0, 0)] * value.ndim
        pad[axis] = (0, target - cur)
        return np.pad(value, pad, constant_values=fill)
    # a tensor (device pixel staging): pad it where it lies
    shape = list(value.shape)
    shape[axis] = target - cur
    return torch.cat([value, value.new_full(shape, fill)], dim=axis)


def _is_image(x: Any) -> bool:
    return hasattr(x, "convert") or (isinstance(x, np.ndarray) and x.ndim >= 2)


class VisualRetrieverCollator:
    query_prefix = "query_"
    pos_doc_prefix = "doc_"
    neg_doc_prefix = "neg_doc_"

    def __init__(
        self,
        processor: BaseVisualRetrieverProcessor,
        max_length: int = 2048,
        pad_seq_to: Optional[PadSpec] = None,
        pad_patches_to: Optional[PadSpec] = None,
        rng: Optional[random.Random] = None,
        device_pixels: bool = False,
    ):
        """``device_pixels=True``: a processor whose ``process_images``
        takes ``device_pixels`` keeps ``pixel_values`` a tensor on its
        device (resized there, or on the host first where it takes
        ``host_resize``), so the pixels are not copied back to the host
        and up again; other processors ignore it."""
        self.processor = processor
        self.max_length = max_length
        self.pad_seq_to = pad_seq_to
        self.pad_patches_to = pad_patches_to
        self._rng = rng or random
        self._image_kwargs = {}
        if device_pixels:
            params = inspect.signature(processor.process_images).parameters
            device_pixels = "device_pixels" in params
            if device_pixels:
                self._image_kwargs = dict(device_pixels=True, **({"host_resize": True} if "host_resize" in params
                                                                 else {}))
        self.device_pixels = device_pixels

    def __call__(self, examples: List[Dict[str, Any]]) -> Dict[str, Any]:
        queries: List[str] = []
        pos_targets: List[Any] = []
        neg_targets: List[Any] = []

        for example in examples:
            if ColPaliEngineDataset.QUERY_KEY not in example:
                raise KeyError(f"Missing {ColPaliEngineDataset.QUERY_KEY} in example.")
            query = example[ColPaliEngineDataset.QUERY_KEY]
            queries.append(self._rng.choice(query) if isinstance(query, list) else query)

            if ColPaliEngineDataset.POS_TARGET_KEY not in example:
                raise KeyError(f"Missing {ColPaliEngineDataset.POS_TARGET_KEY} in example.")
            pos = example[ColPaliEngineDataset.POS_TARGET_KEY]
            pos_targets.append(self._rng.choice(pos) if isinstance(pos, list) else pos)

            neg = example.get(ColPaliEngineDataset.NEG_TARGET_KEY)
            if neg is not None:
                neg_targets.append(neg)

        if not all(isinstance(q, str) for q in queries):
            raise ValueError("All queries must be strings.")

        queries = [
            self.processor.query_prefix + q + self.processor.query_augmentation_token * N_AUGMENTATION_TOKENS
            for q in queries
        ]
        batch = {
            **self.auto_collate(queries, self.query_prefix),
            **self.auto_collate(pos_targets, self.pos_doc_prefix),
        }
        if neg_targets:
            batch.update(self.auto_collate(neg_targets, self.neg_doc_prefix))
        if self.pad_seq_to is not None or self.pad_patches_to is not None:
            batch = self._apply_static_padding(batch)
        return batch

    def auto_collate(self, batch: Sequence[Union[str, Any, list]], key_prefix: str = "") -> Dict[str, Any]:
        """str -> process_texts; image -> process_images; list -> negatives
        reshaped to ``(B, n_neg, ...)``."""
        first = batch[0]
        if isinstance(first, str):
            proc = self.processor.process_texts(texts=list(batch))
        elif isinstance(first, list):
            batch_size = len(batch)
            flat = [item for items in batch for item in items]
            num_neg = len(flat) // batch_size
            if isinstance(flat[0], str):
                proc = self.processor.process_texts(texts=flat)
            elif _is_image(flat[0]):
                proc = self.processor.process_images(images=flat, **self._image_kwargs)
            else:
                raise ValueError(f"Unsupported batch type: {type(flat[0])}.")
            proc = {
                k: v.reshape(batch_size, num_neg, *v.shape[1:])
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == batch_size * num_neg
                else v
                for k, v in proc.items()
            }
        elif _is_image(first):
            proc = self.processor.process_images(images=list(batch), **self._image_kwargs)
        else:
            raise ValueError(f"Unsupported batch type: {type(first)}.")
        return prefix_keys(proc, key_prefix)

    def _apply_static_padding(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Right-pad every sub-batch's sequence axis and visual patch axis to
        fixed buckets, so batches take a bounded set of shapes."""
        out = dict(batch)
        # keep merged patch groups aligned under padding
        group = int(getattr(self.processor, "merge_size", 1)) ** 2
        for prefix in (self.query_prefix, self.pos_doc_prefix, self.neg_doc_prefix):
            ids_key = f"{prefix}input_ids"
            if self.pad_seq_to is not None and ids_key in batch:
                target = pick_bucket(batch[ids_key].shape[-1], self.pad_seq_to)
                for name in ("input_ids", "attention_mask", "position_ids"):
                    key = f"{prefix}{name}"
                    if key in batch:
                        out[key] = _pad_axis(batch[key], -1, target)
            mask_key = f"{prefix}patch_mask"
            if self.pad_patches_to is not None and mask_key in batch:
                target = pick_bucket(batch[mask_key].shape[-1], self.pad_patches_to, multiple=group)
                out[f"{prefix}pixel_values"] = _pad_axis(batch[f"{prefix}pixel_values"], -2, target)
                for name, fill in (("patch_mask", 0), ("vision_hpos", 0), ("vision_wpos", 0), ("window_id", -1)):
                    key = f"{prefix}{name}"
                    if key in batch:
                        out[key] = _pad_axis(batch[key], -1, target, fill)
                for name in ("pos_idx", "pos_weight"):  # (B, P, 4): the patch axis is the second last
                    key = f"{prefix}{name}"
                    if key in batch:
                        out[key] = _pad_axis(batch[key], -2, target)
        return out
