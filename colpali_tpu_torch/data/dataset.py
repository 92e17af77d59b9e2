"""Training dataset containers (the port's copy of
:mod:`colpali_tpu.data.dataset`, pure Python).

The standard sample format ``{query, pos_target, neg_target}`` with optional
external-corpus docid indirection and negative subsampling. Works with
Python lists and HF datasets alike; no ``torch.utils.data.Dataset`` base.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

Document = Any  # str | PIL.Image.Image


class Corpus:
    """docid -> document mapping over a map-style dataset."""

    def __init__(
        self,
        corpus_data: Sequence[Dict[str, Any]],
        docid_to_idx_mapping: Optional[Dict[Any, int]] = None,
        doc_column_name: str = "doc",
    ):
        self.corpus_data = corpus_data
        self.docid_to_idx_mapping = docid_to_idx_mapping
        self.doc_column_name = doc_column_name
        if len(corpus_data) == 0 or doc_column_name not in corpus_data[0]:
            raise ValueError(f"Corpus data must contain a column {doc_column_name}.")

    def __len__(self) -> int:
        return len(self.corpus_data)

    def retrieve(self, docid: Any) -> Document:
        idx = self.docid_to_idx_mapping[docid] if self.docid_to_idx_mapping is not None else docid
        return self.corpus_data[idx][self.doc_column_name]


class ColPaliEngineDataset:
    """Standard training sample format."""

    QUERY_KEY = "query"
    POS_TARGET_KEY = "pos_target"
    NEG_TARGET_KEY = "neg_target"

    def __init__(
        self,
        data: Sequence[Dict[str, Any]],
        corpus: Optional[Corpus] = None,
        query_column_name: str = "query",
        pos_target_column_name: str = "pos_target",
        neg_target_column_name: Optional[str] = None,
        num_negatives: int = 3,
        rng: Optional[random.Random] = None,
    ):
        self.data = data
        self.corpus = corpus
        self.query_column_name = query_column_name
        self.pos_target_column_name = pos_target_column_name
        self.neg_target_column_name = neg_target_column_name
        self.num_negatives = num_negatives
        self._rng = rng or random

        if len(data) == 0:
            raise ValueError("Empty dataset")
        first = data[0]
        if query_column_name not in first:
            raise ValueError(f"Data must contain the {query_column_name} column")
        if pos_target_column_name not in first:
            raise ValueError(f"Data must contain a {pos_target_column_name} column")
        if neg_target_column_name is not None and neg_target_column_name not in first:
            raise ValueError(f"Data must contain a {neg_target_column_name} column")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sample = self.data[idx]
        query = sample[self.query_column_name]

        pos_targets = sample[self.pos_target_column_name]
        if not isinstance(pos_targets, list):
            pos_targets = [pos_targets]

        neg_targets: Optional[List[Any]] = None
        if self.neg_target_column_name is not None:
            neg_targets = sample[self.neg_target_column_name]
            if not isinstance(neg_targets, list):
                neg_targets = [neg_targets]

        if self.corpus is not None:
            pos_targets = [self.corpus.retrieve(doc_id) for doc_id in pos_targets]
            if neg_targets is not None:
                if len(neg_targets) > self.num_negatives:
                    neg_targets = self._rng.sample(list(neg_targets), self.num_negatives)
                neg_targets = [self.corpus.retrieve(doc_id) for doc_id in neg_targets]

        return {
            self.QUERY_KEY: query,
            self.POS_TARGET_KEY: pos_targets,
            self.NEG_TARGET_KEY: neg_targets,
        }

    def take(self, n: int) -> "ColPaliEngineDataset":
        data = self.data.take(n) if hasattr(self.data, "take") else self.data[:n]
        return self.__class__(
            data,
            self.corpus,
            self.query_column_name,
            self.pos_target_column_name,
            self.neg_target_column_name,
            num_negatives=self.num_negatives,
        )
