# Copied from horovod_tpu/torch/elastic/sampler.py:1-91, over the port's basics.
"""Shard-aware elastic sampler.

Parity: reference ``horovod/torch/elastic/sampler.py`` ``ElasticSampler`` —
shards the dataset by (rank, size), tracks processed indices so a rank
re-joining after an elastic reset resumes mid-epoch without repeating data.
"""

from __future__ import annotations

import math
import random
from typing import Iterator, List

import torch.utils.data

from ..common import basics


class ElasticSampler(torch.utils.data.Sampler):
    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def set_epoch(self, epoch: int):
        """New epoch: clear processed set and reshuffle."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Record consumption of one batch of this rank's shard.

        Offsets index ``remaining_indices`` — the list ``__iter__`` actually
        serves — so recording stays correct after a mid-epoch reset has
        filtered out already-processed entries.
        """
        start = self.rank + batch_idx * batch_size * self.num_replicas
        processed = []
        for i in range(batch_size):
            offset = start + i * self.num_replicas
            if offset < self.total_size:
                processed.append(self.remaining_indices[offset])
        self.processed_indices.update(processed)

    def record_indices(self, indices):
        self.processed_indices.update(indices)

    def reset(self):
        """Re-shard after world-size change (called by state.on_reset)."""
        self.num_replicas = basics.size() if basics.is_initialized() else 1
        self.rank = basics.rank() if basics.is_initialized() else 0

        indices = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(indices)
        self.indices = indices

        remaining = [i for i in self.indices
                     if i not in self.processed_indices]
        self.num_samples = int(
            math.ceil(len(remaining) / max(self.num_replicas, 1)))
        self.total_size = self.num_samples * self.num_replicas
        # Pad so every rank sees the same number of samples.
        remaining += remaining[:self.total_size - len(remaining)]
        self.remaining_indices = remaining

    def state_dict(self):
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

    def __iter__(self) -> Iterator[int]:
        return iter(self.remaining_indices[self.rank:self.total_size:
                                           self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples
