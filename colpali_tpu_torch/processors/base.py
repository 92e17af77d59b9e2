"""Base processor: the public API of the retrieval processors (counterpart
of :mod:`colpali_tpu.processors.base`). Outputs are dicts of numpy arrays;
``score*`` is the reference library's scoring API on the plain MaxSim
(``ops.maxsim``), as in JAX."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Sequence

import numpy as np

from colpali_tpu_torch.ops.maxsim import score_multi_vector as _score_multi_vector
from colpali_tpu_torch.ops.maxsim import score_single_vector as _score_single_vector

Batch = Dict[str, np.ndarray]


class BaseVisualRetrieverProcessor(ABC):
    """Abstract processor API for visual retrievers."""

    query_prefix: str = ""
    query_augmentation_token: str = ""

    @abstractmethod
    def process_images(self, images: Sequence[Any]) -> Batch:
        """Process a list of images into model inputs."""

    @abstractmethod
    def process_texts(self, texts: Sequence[str]) -> Batch:
        """Process a list of texts into model inputs."""

    def process_queries(
        self,
        texts: Optional[Sequence[str]] = None,
        queries: Optional[Sequence[str]] = None,
        suffix: Optional[str] = None,
    ) -> Batch:
        """Queries = prefix + text + augmentation suffix; the default suffix is
        10 repetitions of the query-augmentation token."""
        if texts and queries:
            raise ValueError("Only one of 'texts' or 'queries' should be provided.")
        if queries is not None:
            texts = queries
        elif texts is None:
            raise ValueError("No texts or queries provided.")
        if suffix is None:
            suffix = self.query_augmentation_token * 10
        return self.process_texts([self.query_prefix + t + suffix for t in texts])

    def score(self, qs, ps, **kwargs) -> np.ndarray:
        """Default scoring: late-interaction MaxSim -> ``(n_queries, n_passages)``."""
        return self.score_multi_vector(qs, ps, **kwargs)

    @staticmethod
    def score_single_vector(qs, ps) -> np.ndarray:
        return _score_single_vector(qs, ps)

    @staticmethod
    def score_multi_vector(qs, ps, batch_size: int = 128, **kwargs) -> np.ndarray:
        return _score_multi_vector(qs, ps, batch_size=batch_size, **kwargs)
