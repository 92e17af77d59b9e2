"""ColPali processor: PaliGemma prompting (counterpart of
:mod:`colpali_tpu.processors.colpali`, text side).

Queries and texts are ``<bos> + text`` (+ the pad-token augmentation suffix
for queries), right-padded. The tokenizer is injected: any object called as
``tokenizer(texts, padding="longest", padding_side="right",
add_special_tokens=False, return_tensors="np")`` that also has ``bos_token``,
``pad_token`` and ``convert_tokens_to_ids``. Image preprocessing belongs to
the document-embedding slice, not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor, Batch


class ColPaliProcessor(BaseVisualRetrieverProcessor):
    image_token: str = "<image>"

    def __init__(self, tokenizer: Any):
        self.tokenizer = tokenizer
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

    def process_images(self, images: Sequence[Any]) -> Batch:
        raise NotImplementedError("image preprocessing belongs to the document-embedding slice, "
                                  "not ported yet")

    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Queries/texts: BOS + text, right padding."""
        return self._tokenize([self.tokenizer.bos_token + t for t in texts])
