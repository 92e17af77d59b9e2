"""ColModernVBert and BiModernVBert processors (counterpart of
:mod:`colpali_tpu.processors.modernvbert`): the ColIdefics3 processor's
512 px tiles and split-image prompts with ModernVBERT's prompt prefix
``<|begin_of_text|>User:`` (reference processing_colmodernvbert.py), texts
tokenized raw with the ``<end_of_utterance>`` x 10 query suffix, and ids
padded on the **left** (the reference sets the tokenizer's padding side to
left), where the Idefics3 parent pads on the right."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from colpali_tpu_torch.processors.base import Batch
from colpali_tpu_torch.processors.idefics3 import ColIdefics3Processor


class ColModernVBertProcessor(ColIdefics3Processor):
    prompt_prefix: str = "<|begin_of_text|>User:"
    query_augmentation_token: str = "<end_of_utterance>"  # reference processing_colmodernvbert.py:23

    def _tokenize(self, texts: Sequence[str]) -> Batch:
        enc = self.tokenizer(list(texts), padding="longest", padding_side="left", add_special_tokens=False,
                             return_tensors="np")
        return {"input_ids": np.asarray(enc["input_ids"]), "attention_mask": np.asarray(enc["attention_mask"])}


class BiModernVBertProcessor(ColModernVBertProcessor):
    """Dense variant: cosine of pooled vectors (reference processing_bimodernvbert.py)."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)
