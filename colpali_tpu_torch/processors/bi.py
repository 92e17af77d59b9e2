"""Bi-encoder (single-vector) processors (counterpart of
:mod:`colpali_tpu.processors.bi`): each is its family's Col processor with
``score`` as the cosine of pooled vectors (``score_single_vector``). The
reference's ``process_texts`` overrides restate the Col behaviour (raw
tokenization), which the Col processors already have."""

from __future__ import annotations

import numpy as np

from colpali_tpu_torch.processors.colpali import ColPaliProcessor
from colpali_tpu_torch.processors.idefics3 import ColIdefics3Processor
from colpali_tpu_torch.processors.qwen2_5_vl import ColQwen2_5Processor
from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
from colpali_tpu_torch.processors.qwen3_vl import ColQwen3_5Processor, ColQwen3Processor


class BiPaliProcessor(ColPaliProcessor):
    """reference processing_bipali.py:8-26."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


class BiQwen2Processor(ColQwen2Processor):
    """reference processing_biqwen2.py:9-43."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


class BiQwen2_5_Processor(ColQwen2_5Processor):  # noqa: N801 (the reference's name)
    """reference processing_biqwen2_5.py:9-40."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


class BiQwen3Processor(ColQwen3Processor):
    """reference processing_biqwen3.py:9-37."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


class BiQwen3_5Processor(ColQwen3_5Processor):  # noqa: N801 (the reference's name)
    """reference processing_biqwen3_5.py:9-37."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)


class BiIdefics3Processor(ColIdefics3Processor):
    """reference processing_biidefics3.py:9-40."""

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        return self.score_single_vector(qs, ps)
