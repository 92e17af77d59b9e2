"""Base processor: the public API of the retrieval processors (counterpart
of :mod:`colpali_tpu.processors.base`). Outputs are dicts of numpy arrays;
``score*`` is the reference library's scoring API on the plain MaxSim
(``ops.maxsim``), as in JAX. :meth:`save_pretrained` writes the tokenizer
(when it can save itself) and the image-pipeline configs, so that the
family's ``from_pretrained`` rebuilds the processor from the directory."""

from __future__ import annotations

from abc import ABC, abstractmethod
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from colpali_tpu_torch.ops.maxsim import score_multi_vector as _score_multi_vector
from colpali_tpu_torch.ops.maxsim import score_single_vector as _score_single_vector

Batch = Dict[str, np.ndarray]


class BaseVisualRetrieverProcessor(ABC):
    """Abstract processor API for visual retrievers."""

    query_prefix: str = ""
    query_augmentation_token: str = ""

    def save_pretrained(self, output_dir: str) -> None:
        """Write the tokenizer files (if the tokenizer has ``save_pretrained``)
        and ``preprocessor_config.json`` / ``processor_config.json`` from
        :meth:`_export_configs`."""
        os.makedirs(output_dir, exist_ok=True)
        tok = getattr(self, "tokenizer", None)
        if tok is not None and hasattr(tok, "save_pretrained"):
            tok.save_pretrained(output_dir)
        preprocessor_cfg, processor_cfg = self._export_configs()
        for name, cfg in (("preprocessor_config.json", preprocessor_cfg), ("processor_config.json", processor_cfg)):
            if cfg:
                with open(os.path.join(output_dir, name), "w") as f:
                    json.dump(cfg, f, indent=2)

    def _export_configs(self) -> tuple:
        """``(preprocessor_config.json, processor_config.json)`` dicts, as the
        family's ``from_pretrained`` reads them; empty means not written."""
        return {}, {}

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
        max_length: int = 50,  # noqa: ARG002 (accepted and unused, as in JAX and the reference)
        contexts: Optional[Sequence[str]] = None,  # noqa: ARG002 (likewise)
        suffix: Optional[str] = None,
    ) -> Batch:
        """Queries = prefix + text + augmentation suffix; the default suffix is
        10 repetitions of the query-augmentation token. ``max_length`` and
        ``contexts`` are accepted for the reference's signature and unused."""
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

    @abstractmethod
    def get_n_patches(self, image_size: Tuple[int, int], *args, **kwargs) -> Tuple[int, int]:
        """``(n_patches_x, n_patches_y)`` used for an image of ``(height, width)``."""


def load_tokenizer(path: str):
    """The checkpoint's tokenizer through ``transformers.AutoTokenizer``, or
    ``PreTrainedTokenizerFast`` when the installed ``transformers`` does not
    know the config's ``model_type``. ``transformers`` is imported here
    only: the weights and the rest of the port do not need it."""
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(path)
    except (ValueError, KeyError):
        from transformers import PreTrainedTokenizerFast

        return PreTrainedTokenizerFast.from_pretrained(path)
