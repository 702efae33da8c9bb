"""Batch loader and device prefetch (counterpart of
distribuuuu_tpu/data/loader.py).

Train: shuffled sampler, ``drop_last``. Val: unshuffled, the ragged tail
kept and padded to the full batch with ``mask`` 0, so the eval sums skip
the padding. A thread pool assembles numpy batches ahead of the consumer;
:func:`device_prefetch` copies the next ``TRAIN.PREFETCH_DEVICE`` batches
to the card (pinned host buffers, ``non_blocking``) while the current step
runs.

Each batch is a dict: ``image`` [B,H,W,3] (uint8 under
``DATA.DEVICE_NORMALIZE``, else float32, NHWC), ``label`` [B] int32,
``mask`` [B] float32. The port trains on one process and one device, so a
batch is ``BATCH_SIZE`` samples.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.data.sampler import DistributedSampler


class Loader:
    """Iterates a dataset as batches in the sampler's order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 workers: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self.sampler = DistributedSampler(len(dataset), shuffle=shuffle, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, idxs: np.ndarray) -> dict:
        samples = [self.dataset[int(i)] for i in idxs]
        images = np.stack([s[0] for s in samples])
        n = len(samples)
        batch = {
            "image": images,
            "label": np.asarray([s[1] for s in samples], np.int32),
            "mask": np.ones((n,), np.float32),
        }
        if n < self.batch_size:  # the ragged eval tail: pad, mask out
            pad = self.batch_size - n
            batch["image"] = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            batch["label"] = np.concatenate([batch["label"], np.zeros(pad, np.int32)])
            batch["mask"] = np.concatenate([batch["mask"], np.zeros(pad, np.float32)])
        return batch

    def __iter__(self):
        idxs = self.sampler.indices()
        chunks = [idxs[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            in_flight: deque = deque(pool.submit(self._assemble, c)
                                     for c in chunks[:self.workers])
            for c in chunks[self.workers:]:
                batch = in_flight.popleft().result()
                in_flight.append(pool.submit(self._assemble, c))
                yield batch
            while in_flight:
                yield in_flight.popleft().result()


def _to_device(host: dict, device: torch.device, pin: bool) -> dict:
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        out[k] = t
    return out


def device_prefetch(loader, device: torch.device, depth: int, pin: bool = True):
    """Yields ``(it, device_batch, timing)`` in loader order, keeping the
    next ``depth`` batches already copied (on the card: pinned buffers and
    ``non_blocking`` copies on the current stream, so they overlap the
    step on batch ``it``). ``timing`` has ``get0/get1`` (waiting for the
    host batch) and ``put0/put1`` (issuing the copy). Every depth yields
    the same batches in the same order."""
    src = iter(loader)
    ring: deque = deque()
    exhausted, it = False, 0
    while True:
        while not exhausted and len(ring) < max(0, depth) + 1:
            get0 = time.perf_counter()
            hb = next(src, None)
            if hb is None:
                exhausted = True
                break
            tl = {"get0": get0, "get1": time.perf_counter()}
            tl["put0"] = time.perf_counter()
            db = _to_device(hb, device, pin)
            tl["put1"] = time.perf_counter()
            ring.append((db, tl))
        if not ring:
            return
        db, tl = ring.popleft()
        yield it, db, tl
        it += 1


def _build_dataset(train: bool):
    if cfg.MODEL.DUMMY_INPUT:
        # model-input-sized dummies for both splits, as the JAX package
        return DummyDataset(length=cfg.TRAIN.BATCH_SIZE * 64, size=cfg.TRAIN.IM_SIZE,
                            raw_u8=bool(cfg.DATA.DEVICE_NORMALIZE))
    split = "train" if train else "val"
    raise not_ported(
        f"the {split} dataset at {cfg.TRAIN.DATASET if train else cfg.TEST.DATASET!r} "
        "(ImageFolder, shards and token pipelines; pass MODEL.DUMMY_INPUT True to "
        "train on generated images)", "Real data and many processes")


def construct_train_loader() -> Loader:
    """The train pipeline: shuffled, ``drop_last``."""
    return Loader(_build_dataset(True), cfg.TRAIN.BATCH_SIZE, shuffle=True,
                  drop_last=True, workers=cfg.TRAIN.WORKERS, seed=cfg.RNG_SEED or 0)


def construct_val_loader() -> Loader:
    """The val pipeline: unshuffled, the ragged tail kept and masked."""
    return Loader(_build_dataset(False), cfg.TEST.BATCH_SIZE, shuffle=False,
                  drop_last=False, workers=cfg.TRAIN.WORKERS, seed=cfg.RNG_SEED or 0)
