"""Distributed sampling with torch-DistributedSampler semantics
(counterpart of distribuuuu_tpu/data/sampler.py): a per-epoch seeded
global shuffle, round-robin rank assignment, padding by repeating the head
so every rank sees as many items, ``set_epoch`` to reshuffle. The loader
passes the process group's ``(rank, world)``."""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        if not self.drop_last and len(order) < self.total_size:
            order = np.concatenate([order, order[: self.total_size - len(order)]])
        else:
            order = order[: self.total_size]
        return order[self.rank :: self.num_replicas]

    def __len__(self):
        return self.num_samples
