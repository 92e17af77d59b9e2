"""Multi-dataset batch sampling (the port's copy of
:mod:`colpali_tpu.data.sampler`, pure numpy, so that both packages draw the
same batches from a seed).

Every batch is drawn from a SINGLE dataset (chosen with probability
proportional to its remaining size), indices are global (offset by
cumulative dataset sizes), incomplete tails are dropped, and ``set_epoch``
reshuffles deterministically.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class SingleDatasetBatchSampler:
    def __init__(
        self,
        datasets: Sequence,
        global_batch_size: int,
        drop_last: bool = True,
        seed: int = 0,
    ):
        if not drop_last:
            raise NotImplementedError("drop_last=False is not supported")
        self.datasets = datasets
        self.global_batch_size = global_batch_size
        self.initial_seed = seed
        self._rng = np.random.default_rng(seed)

        self.dataset_sizes = [len(d) for d in datasets]
        self.cumsum_sizes = np.concatenate([[0], np.cumsum(self.dataset_sizes)]).tolist()
        self.total_size = sum(self.dataset_sizes)
        self.max_positions = [
            (size // global_batch_size) * global_batch_size for size in self.dataset_sizes
        ]
        self._reshuffle(self._rng)

    def _reshuffle(self, rng: np.random.Generator) -> None:
        self.indices_per_dataset = [rng.permutation(size).tolist() for size in self.dataset_sizes]

    def __iter__(self) -> Iterator[List[int]]:
        positions = [0] * len(self.datasets)
        available = [i for i, m in enumerate(self.max_positions) if m > 0]
        remaining = list(self.dataset_sizes)

        while available:
            total = sum(remaining[i] for i in available)
            if total <= 0:
                break
            probs = np.asarray([remaining[i] / total for i in available])
            ds = available[int(self._rng.choice(len(available), p=probs))]

            start = positions[ds]
            end = start + self.global_batch_size
            if end <= self.max_positions[ds]:
                batch = [
                    idx + self.cumsum_sizes[ds] for idx in self.indices_per_dataset[ds][start:end]
                ]
                positions[ds] = end
                remaining[ds] = self.dataset_sizes[ds] - end
                if end >= self.max_positions[ds]:
                    available.remove(ds)
                yield batch
            else:
                available.remove(ds)

    def set_epoch(self, epoch: int) -> None:
        """Deterministic per-epoch reshuffle."""
        seed = self.initial_seed + epoch
        self._rng = np.random.default_rng(seed)
        self._reshuffle(np.random.default_rng(seed))

    @property
    def batch_size(self) -> int:
        return self.global_batch_size

    def __len__(self) -> int:
        return sum(size // self.global_batch_size for size in self.dataset_sizes)
