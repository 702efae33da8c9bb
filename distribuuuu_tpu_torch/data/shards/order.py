"""The shards' sample order (counterpart of distribuuuu_tpu/data/shards/order.py,
numpy only, the same bits).

An epoch's global order is a function of ``(seed, epoch)`` alone, never of
the world size or the rank. Every rank strides the same order (rank r
takes ``order[r::world]``, as ``DistributedSampler`` does), so after k
global batches the samples consumed are ``order[:k × global_batch]`` at
any world size: the saved global cursor means the same thing to a resume
on another number of processes.

The order is built for sequential shard reads: storage order is cut into
``block``-record runs, the runs are permuted, and a ``window``-sample
shuffle buffer mixes neighbours, so each read lands within about
``window`` records of a sequential sweep. At ``block=1, window=n`` it is a
uniform shuffle.
"""

from __future__ import annotations

import numpy as np


def shuffle_rng(seed: int, epoch: int) -> np.random.Generator:
    """The epoch's shuffle generator, from ``(seed, epoch)`` alone."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch)]))


def global_order(n: int, seed: int, epoch: int, block: int = 64,
                 window: int = 1024) -> np.ndarray:
    """The epoch's permutation of ``[0, n)`` (int64), both stages drawn
    from :func:`shuffle_rng`: the ``block``-record runs permuted, then a
    ``window``-slot buffer over that stream emits a uniformly drawn slot a
    step (refilled from the stream) and drains shuffled."""
    n, block, window = int(n), max(1, int(block)), max(1, int(window))
    if n <= 0:
        return np.empty((0,), np.int64)
    rng = shuffle_rng(seed, epoch)
    n_blocks = -(-n // block)
    stream = np.concatenate([np.arange(b * block, min((b + 1) * block, n), dtype=np.int64)
                             for b in rng.permutation(n_blocks)])
    w = min(window, n)
    if w <= 1:
        return stream
    buf = stream[:w].copy()
    out = np.empty((n,), np.int64)
    draws = rng.integers(0, w, size=n - w)
    for k in range(n - w):
        j = draws[k]
        out[k] = buf[j]
        buf[j] = stream[w + k]
    rng.shuffle(buf)
    out[n - w:] = buf
    return out


class WindowShuffleSampler:
    """``data/sampler.DistributedSampler``'s contract (padding by wrapping
    to a multiple of the world, rank r takes ``order[r::world]``) over
    :func:`global_order`, plus :meth:`order_state`, the identity of the
    epoch's shuffle that ``Loader.state_dict`` saves and a resume checks
    before it trusts a cursor."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int, seed: int = 0,
                 block: int = 64, window: int = 1024, drop_last: bool = False):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_len = int(dataset_len)
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = int(seed)
        self.block = int(block)
        self.window = int(window)
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas
        self._cache: tuple[int, np.ndarray] | None = None  # (epoch, order)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def epoch_order(self) -> np.ndarray:
        """The epoch's global order (every rank's), cached."""
        if self._cache is None or self._cache[0] != self.epoch:
            self._cache = (self.epoch, global_order(self.dataset_len, self.seed, self.epoch,
                                                    self.block, self.window))
        return self._cache[1]

    def indices(self) -> np.ndarray:
        order = self.epoch_order()
        if not self.drop_last and len(order) < self.total_size:
            order = np.concatenate([order, order[:self.total_size - len(order)]])
        else:
            order = order[:self.total_size]
        return order[self.rank::self.num_replicas]

    def order_state(self) -> dict:
        """The knobs that fix the epoch's order and the shuffle
        generator's initial state (the bit generator's dict: plain ints,
        JSON-able). A restored cursor is honoured only when the live
        sampler gives the same dict."""
        return {
            "kind": "window_shuffle",
            "seed": self.seed,
            "epoch": int(self.epoch),
            "block": self.block,
            "window": self.window,
            "num_records": self.dataset_len,
            "rng_state": shuffle_rng(self.seed, self.epoch).bit_generator.state,
        }

    def __len__(self):
        return self.num_samples
