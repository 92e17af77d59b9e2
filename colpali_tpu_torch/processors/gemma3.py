"""ColGemma3 / BiGemma3 processors: Gemma3 chat-template prompting
(counterpart of :mod:`colpali_tpu.processors.gemma3`).

- Pages are rendered through Gemma3's chat template, user turn, no
  generation prompt: ``<bos><start_of_turn>user\\n<start_of_image>Describe
  this image<end_of_turn>\\n``, the ``<start_of_image>`` expanded as HF
  Gemma3Processor does (processing_gemma3.py:60-76) into ``"\\n\\n" +
  <start_of_image> + <image_soft_token> x image_seq_length + <end_of_image>
  + "\\n\\n"``. Pixels are resized square to ``image_size`` (896 for
  Gemma3-4B) and normalized with mean and std 0.5, as
  :func:`~colpali_tpu_torch.processors.image_processing.preprocess_images_fixed`
  does (``jax.image.resize``'s bicubic on :attr:`device`, or PIL first with
  ``host_resize``).
- Queries are ``Query: {text}`` through the same template:
  ``process_queries`` is ``process_texts``, with no augmentation suffix
  (reference processing_colgemma.py:161-177).
- Ids pad on the left (the reference sets ``tokenizer.padding_side``).

The tokenizer is injected as for the other families: ``from_pretrained(path,
tokenizer=...)`` or :func:`~colpali_tpu_torch.processors.base.load_tokenizer`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch, load_tokenizer
from colpali_tpu_torch.processors.image_processing import preprocess_images_fixed


class ColGemma3Processor(BaseVisualRetrieverProcessor):
    boi_token: str = "<start_of_image>"
    eoi_token: str = "<end_of_image>"
    image_token: str = "<image_soft_token>"
    doc_prompt: str = "Describe this image"
    query_prefix: str = "Query: "

    def __init__(
        self,
        tokenizer: Any,
        image_size: int = 896,
        patch_size: int = 14,
        image_seq_length: int = 256,
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
    def from_pretrained(cls, path: str, **kwargs) -> "ColGemma3Processor":
        """A processor for the checkpoint directory ``path``: the image size,
        mean and std of its ``preprocessor_config.json``, the
        ``image_seq_length`` of its ``processor_config.json``, then ``kwargs``
        over those. The tokenizer is ``kwargs["tokenizer"]`` or
        :func:`load_tokenizer` on ``path``."""
        tokenizer = kwargs.pop("tokenizer", None) or load_tokenizer(path)
        init_kwargs: Dict[str, Any] = {}
        pp_path = os.path.join(path, "preprocessor_config.json")
        if os.path.exists(pp_path):
            with open(pp_path) as f:
                pp = json.load(f)
            init_kwargs["image_size"] = pp.get("size", {}).get("height", 896)
            init_kwargs["image_mean"] = pp.get("image_mean", (0.5, 0.5, 0.5))
            init_kwargs["image_std"] = pp.get("image_std", (0.5, 0.5, 0.5))
        proc_path = os.path.join(path, "processor_config.json")
        if os.path.exists(proc_path):
            with open(proc_path) as f:
                init_kwargs["image_seq_length"] = json.load(f).get("image_seq_length", 256)
        init_kwargs.update(kwargs)
        return cls(tokenizer, **init_kwargs)

    def _export_configs(self) -> tuple:
        pp = {
            "size": {"height": self.image_size, "width": self.image_size},
            "image_mean": list(self.image_mean),
            "image_std": list(self.image_std),
        }
        return pp, {"image_seq_length": self.image_seq_length}

    @property
    def query_augmentation_token(self) -> str:
        """The reference declares ``<eos>`` (processing_colgemma.py:49);
        its ``process_queries`` never appends it."""
        return self.tokenizer.eos_token

    def _chat(self, content: str) -> str:
        """Gemma3's chat template: one user turn, no generation prompt."""
        return f"{self.tokenizer.bos_token}<start_of_turn>user\n{content}<end_of_turn>\n"

    def _expand_images(self, text: str) -> str:
        full = f"\n\n{self.boi_token}{self.image_token * self.image_seq_length}{self.eoi_token}\n\n"
        return text.replace(self.boi_token, full)

    def _tokenize(self, texts: Sequence[str]) -> Batch:
        enc = self.tokenizer(list(texts), padding="longest", padding_side="left", add_special_tokens=False,
                             return_tensors="np")
        return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}

    def process_images(self, images: Sequence[Any], context_prompts: Optional[Sequence[str]] = None,
                       device_pixels: bool = False, host_resize: bool = False) -> Batch:
        """Pages -> left-padded ids and mask and ``(B, size, size, 3)`` fp32
        normalized pixels, resized on :attr:`device` (``host_resize=True``:
        with PIL on the host first). ``device_pixels=True`` leaves the
        pixels there as a tensor; otherwise they come back as numpy."""
        prompts = list(context_prompts) if context_prompts else [self.doc_prompt] * len(images)
        if len(prompts) != len(images):
            raise ValueError(f"Got {len(images)} images but {len(prompts)} prompts")
        batch = self._tokenize([self._expand_images(self._chat(f"{self.boi_token}{p}")) for p in prompts])
        pixels = preprocess_images_fixed(images, size=(self.image_size, self.image_size), mean=self.image_mean,
                                         std=self.image_std, device=self.device, host_resize=host_resize)
        batch["pixel_values"] = pixels if device_pixels else pixels.cpu().numpy()
        return batch

    def process_texts(self, texts: Sequence[str]) -> Batch:
        return self._tokenize([self._chat(f"{self.query_prefix}{t}") for t in texts])

    def process_queries(self, texts: Optional[Sequence[str]] = None, queries: Optional[Sequence[str]] = None,
                        **kwargs) -> Batch:  # noqa: ARG002 (the base signature's options, unused as in JAX)
        """:meth:`process_texts`: the reference applies no augmentation suffix."""
        if texts and queries:
            raise ValueError("Only one of 'texts' or 'queries' should be provided.")
        texts = queries if queries is not None else texts
        if texts is None:
            raise ValueError("No texts or queries provided.")
        return self.process_texts(texts)

    def get_n_patches(self, image_size: Tuple[int, int], patch_size: Optional[int] = None) -> Tuple[int, int]:
        """The pooled grid, ``sqrt(image_seq_length)`` a side (16 x 16), as
        in JAX: the reference returns the raw 64 x 64 patch grid
        (processing_colgemma.py:243-267), which does not match its 256
        image tokens."""
        side = int(self.image_seq_length**0.5)
        return side, side

    def get_image_mask(self, batch: Batch) -> np.ndarray:
        return np.asarray(batch["input_ids"]) == self.image_token_id


class BiGemma3Processor(ColGemma3Processor):
    """reference processing_bigemma.py: the same prompting; ``score`` is the
    cosine of pooled vectors."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


# the reference's own exported names put the "3" after "Processor" (processing_colgemma.py:24,
# processing_bigemma.py:11); both spellings are importable, as in JAX
ColGemmaProcessor3 = ColGemma3Processor
BiGemmaProcessor3 = BiGemma3Processor
