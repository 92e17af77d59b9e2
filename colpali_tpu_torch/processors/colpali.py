"""ColPali processor: PaliGemma prompting and SigLIP preprocessing
(counterpart of :mod:`colpali_tpu.processors.colpali`).

Queries and texts are ``<bos> + text`` (+ the pad-token augmentation suffix
for queries), right-padded. Pages are ``visual_prompt_prefix`` with its
``<image>`` expanded to ``image_seq_length`` copies, ``<bos>`` after the last
one and a trailing newline (HF PaliGemmaProcessor), plus pixels resized on
the host (:mod:`colpali_tpu_torch.processors.image_processing`). The
tokenizer is injected: any object called as ``tokenizer(texts,
padding="longest", padding_side="right", add_special_tokens=False,
return_tensors="np")`` that also has ``bos_token``, ``pad_token`` and
``convert_tokens_to_ids``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch
from colpali_tpu_torch.processors.image_processing import preprocess_images_fixed


class ColPaliProcessor(BaseVisualRetrieverProcessor):
    visual_prompt_prefix: str = "<image><bos>Describe the image."
    image_token: str = "<image>"

    def __init__(
        self,
        tokenizer: Any,
        image_size: int = 448,
        image_seq_length: int = 1024,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
    ):
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.image_seq_length = image_seq_length
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.image_token)

    @classmethod
    def from_pretrained(cls, path: str) -> "ColPaliProcessor":
        """Load the tokenizer from an HF checkpoint directory (needs ``transformers``)."""
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path))

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
        host_resize: bool = True,
    ) -> Batch:
        """Pages -> token ids, mask and ``(B, size, size, 3)`` fp32 normalized
        pixels (numpy), resized on the host. ``host_resize=False`` (resize on
        the device) is not ported yet and raises."""
        if not host_resize:
            raise NotImplementedError(
                "device resize is not ported: JAX resizes with jax.image.resize bicubic + antialias "
                "(Keys a=-0.5) while F.interpolate uses a=-0.75; pass host_resize=True")
        prompts = list(context_prompts) if context_prompts else [self.visual_prompt_prefix] * len(images)
        if len(prompts) != len(images):
            raise ValueError(f"Got {len(images)} images but {len(prompts)} prompts")
        batch = self._tokenize([self._expand_image_prompt(p) for p in prompts])
        batch["pixel_values"] = preprocess_images_fixed(
            images, size=(self.image_size, self.image_size), mean=self.image_mean, std=self.image_std)
        return batch

    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Queries/texts: BOS + text, right padding."""
        return self._tokenize([self.tokenizer.bos_token + t for t in texts])

    def get_image_mask(self, batch: Batch) -> np.ndarray:
        return batch["input_ids"] == self.image_token_id
