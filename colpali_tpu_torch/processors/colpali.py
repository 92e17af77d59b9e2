"""ColPali processor: PaliGemma prompting and SigLIP preprocessing
(counterpart of :mod:`colpali_tpu.processors.colpali`).

Queries and texts are ``<bos> + text`` (+ the pad-token augmentation suffix
for queries), right-padded. Pages are ``visual_prompt_prefix`` with its
``<image>`` expanded to ``image_seq_length`` copies, ``<bos>`` after the last
one and a trailing newline (HF PaliGemmaProcessor), plus pixels resized as
``jax.image.resize`` does (bicubic, antialiased) on ``device``, or with PIL
on the host (:mod:`colpali_tpu_torch.processors.image_processing`). The
tokenizer is injected: any object called as ``tokenizer(texts,
padding="longest", padding_side="right", add_special_tokens=False,
return_tensors="np")`` that also has ``bos_token``, ``pad_token`` and
``convert_tokens_to_ids``. :meth:`ColPaliProcessor.from_pretrained` loads
one with ``transformers`` unless ``tokenizer=`` is given.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch, load_tokenizer
from colpali_tpu_torch.processors.image_processing import preprocess_images_fixed


class ColPaliProcessor(BaseVisualRetrieverProcessor):
    visual_prompt_prefix: str = "<image><bos>Describe the image."
    image_token: str = "<image>"

    def __init__(
        self,
        tokenizer: Any,
        image_size: int = 448,
        patch_size: int = 14,
        image_seq_length: int = 1024,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
        device: Union[str, torch.device] = "cuda",
    ):
        """``device``: where :meth:`process_images` resizes and normalizes."""
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.patch_size = patch_size
        self.image_seq_length = image_seq_length
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.device = torch.device(device)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.image_token)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "ColPaliProcessor":
        """A processor for the HF checkpoint directory ``path``: the image
        size, mean and std from its ``preprocessor_config.json`` (448 and 0.5
        when absent), ``image_seq_length = (image_size // 14) ** 2``, then
        ``kwargs`` over those. The tokenizer is ``kwargs["tokenizer"]`` or
        :func:`load_tokenizer` (``transformers``) on ``path``."""
        tokenizer = kwargs.pop("tokenizer", None) or load_tokenizer(path)
        init_kwargs = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
            init_kwargs["image_size"] = pp.get("size", {}).get("height", 448)
            init_kwargs["image_mean"] = pp.get("image_mean", (0.5, 0.5, 0.5))
            init_kwargs["image_std"] = pp.get("image_std", (0.5, 0.5, 0.5))
        init_kwargs["image_seq_length"] = (init_kwargs.get("image_size", 448) // 14) ** 2
        init_kwargs.update(kwargs)
        return cls(tokenizer, **init_kwargs)

    def _export_configs(self) -> tuple:
        pp = {
            "size": {"height": self.image_size, "width": self.image_size},
            "image_mean": list(self.image_mean),
            "image_std": list(self.image_std),
        }
        return pp, {}

    @property
    def query_augmentation_token(self) -> str:
        """The tokenizer's pad token."""
        return self.tokenizer.pad_token

    def _tokenize(self, texts: Sequence[str]) -> Batch:
        enc = self.tokenizer(
            list(texts),
            padding="longest",
            padding_side="right",
            add_special_tokens=False,
            return_tensors="np",
        )
        return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}

    def _expand_image_prompt(self, text: str) -> str:
        """``<image>`` x ``image_seq_length``, BOS after the last image token,
        trailing newline (HF PaliGemmaProcessor)."""
        expanded = text.replace(self.image_token, self.image_token * self.image_seq_length)
        idx = expanded.rfind(self.image_token)
        bos_at = idx + len(self.image_token) if idx != -1 else 0
        expanded = expanded[:bos_at] + self.tokenizer.bos_token + expanded[bos_at:]
        return expanded + "\n"

    def process_images(
        self,
        images: Sequence[Any],
        context_prompts: Optional[Sequence[str]] = None,
        device_pixels: bool = False,
        host_resize: bool = False,
    ) -> Batch:
        """Pages -> token ids, mask and ``(B, size, size, 3)`` fp32 normalized
        pixels, resized on :attr:`device` (``host_resize=True``: with PIL on
        the host first). ``device_pixels=True`` leaves the pixels there as a
        tensor; otherwise they come back as numpy."""
        prompts = list(context_prompts) if context_prompts else [self.visual_prompt_prefix] * len(images)
        if len(prompts) != len(images):
            raise ValueError(f"Got {len(images)} images but {len(prompts)} prompts")
        batch = self._tokenize([self._expand_image_prompt(p) for p in prompts])
        pixels = preprocess_images_fixed(images, size=(self.image_size, self.image_size), mean=self.image_mean,
                                         std=self.image_std, device=self.device, host_resize=host_resize)
        batch["pixel_values"] = pixels if device_pixels else pixels.cpu().numpy()
        return batch

    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Queries/texts: BOS + text, right padding."""
        return self._tokenize([self.tokenizer.bos_token + t for t in texts])

    def get_n_patches(self, image_size: Tuple[int, int], patch_size: Optional[int] = None) -> Tuple[int, int]:
        """Pages are resized to a square: the same grid whatever ``image_size``."""
        patch_size = patch_size or self.patch_size
        return self.image_size // patch_size, self.image_size // patch_size

    def get_image_mask(self, batch: Batch) -> np.ndarray:
        return batch["input_ids"] == self.image_token_id
