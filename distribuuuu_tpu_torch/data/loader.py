"""Batch loader and device prefetch (counterpart of
distribuuuu_tpu/data/loader.py).

Train: shuffled sampler, ``drop_last``. Val: unshuffled, the ragged tail
kept and padded to the full batch with ``mask`` 0, so the eval sums skip
the padding. Each process loads its own shard: the sampler takes
``(rank, world)`` from the process group (``parallel/dist.py``) and pads
by repeating the head of the order, so with several processes the eval
counts those repeats, as the JAX package does. A thread pool assembles
numpy batches ahead of the consumer; with the native decoder each batch is
one call over ``TRAIN.WORKERS`` C++ threads and two batches are in
flight, with PIL the pool's ``TRAIN.WORKERS`` threads are the parallelism.
A failed decode is retried with exponential backoff (``DATA.RETRIES``,
``DATA.RETRY_BACKOFF_S``), then, under ``DATA.SKIP_CORRUPT``, the corrupt
sample is replaced by a good one from its batch and logged.
:func:`device_prefetch` copies the next ``TRAIN.PREFETCH_DEVICE`` batches
to the card (pinned host buffers, ``non_blocking``) while the current step
runs.

Each batch is a dict: ``image`` [B,H,W,3] (uint8 under
``DATA.DEVICE_NORMALIZE``, else float32, NHWC), ``label`` [B] int32,
``mask`` [B] float32, with B the per-process batch.
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
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.utils.logger import get_logger


class Loader:
    """Iterates this process's shard of a dataset as batches in the
    sampler's order."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 workers: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.workers = max(1, workers)
        use_native = getattr(dataset, "_use_native", None)
        self.backend = ("native" if use_native() else "pil") if use_native else "dummy"
        self.prefetch_depth = 2 if self.backend == "native" else self.workers
        self.retries = max(0, int(cfg.DATA.RETRIES))
        self.retry_backoff = float(cfg.DATA.RETRY_BACKOFF_S)
        self.skip_corrupt = bool(cfg.DATA.SKIP_CORRUPT)
        self.sampler = DistributedSampler(len(dataset), num_replicas=dist.get_world_size(),
                                          rank=dist.get_rank(), shuffle=shuffle, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(epoch)

    def __len__(self):
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _with_retries(self, fn, what: str):
        """``fn()`` retried with exponential backoff; the last error, or
        the result."""
        delay, err = self.retry_backoff, None
        for attempt in range(self.retries + 1):
            try:
                return fn(), None
            except Exception as e:  # a decoder raises many concrete types
                err = e
                if attempt < self.retries:
                    time.sleep(delay)
                    delay *= 2
        if not self.skip_corrupt:
            raise RuntimeError(f"{what} failed decode after {self.retries + 1} attempts "
                               "(DATA.SKIP_CORRUPT False: fail-stop)") from err
        return None, err

    def _fetch_sample(self, i: int):
        """One sample behind retry-with-backoff; None marks a corrupt
        sample (logged) for the caller to substitute."""
        sample, err = self._with_retries(lambda: self.dataset[int(i)], f"sample {int(i)}")
        if err is not None:
            get_logger().warning("corrupt sample %d skipped after %d attempts (%s: %s): "
                                 "substituting a good sample from the same batch", int(i),
                                 self.retries + 1, type(err).__name__, err)
        return sample

    def _decode(self, idxs) -> tuple[np.ndarray, np.ndarray]:
        """``(images, labels)`` through the dataset's batch decode when it
        has one, else sample by sample. A batch decode that keeps failing
        falls back to the per-sample path, which isolates and substitutes
        the corrupt samples instead of ending the epoch."""
        if hasattr(self.dataset, "load_batch"):
            out, err = self._with_retries(
                lambda: self.dataset.load_batch(idxs, n_threads=self.workers), "batch")
            if err is None:
                return out
            get_logger().warning("batch decode failed after %d attempts (%s: %s): "
                                 "isolating per sample", self.retries + 1,
                                 type(err).__name__, err)
        samples = [self._fetch_sample(i) for i in idxs]
        good = [s for s in samples if s is not None]
        if not good:
            raise RuntimeError(
                f"all {len(samples)} samples in the batch failed decode: not a stray "
                "corrupt file; check the dataset and its storage (first indices: "
                + ", ".join(str(int(i)) for i in list(idxs)[:4]) + ")")
        samples = [s if s is not None else good[0] for s in samples]
        return np.stack([s[0] for s in samples]), np.asarray([s[1] for s in samples], np.int32)

    def _assemble(self, idxs: np.ndarray) -> dict:
        images, labels = self._decode(idxs)
        images = np.asarray(images)
        img_dtype = np.uint8 if images.dtype == np.uint8 else np.float32
        n = len(images)
        batch = {
            "image": images.astype(img_dtype, copy=False),
            "label": np.asarray(labels, np.int32),
            "mask": np.ones((n,), np.float32),
        }
        if n < self.batch_size:  # the ragged eval tail: pad, mask out
            pad = self.batch_size - n
            batch["image"] = np.concatenate(
                [batch["image"], np.zeros((pad,) + images.shape[1:], img_dtype)])
            batch["label"] = np.concatenate([batch["label"], np.zeros(pad, np.int32)])
            batch["mask"] = np.concatenate([batch["mask"], np.zeros(pad, np.float32)])
        return batch

    def __iter__(self):
        idxs = self.sampler.indices()
        chunks = [idxs[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        depth = self.prefetch_depth
        with ThreadPoolExecutor(max_workers=depth) as pool:
            in_flight: deque = deque(pool.submit(self._assemble, c) for c in chunks[:depth])
            for c in chunks[depth:]:
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
    raw_u8 = bool(cfg.DATA.DEVICE_NORMALIZE)
    if cfg.MODEL.DUMMY_INPUT:
        # model-input-sized dummies for both splits, as the JAX package
        return DummyDataset(length=cfg.TRAIN.BATCH_SIZE * 64, size=cfg.TRAIN.IM_SIZE,
                            raw_u8=raw_u8)
    if cfg.DATA.FORMAT != "imagefolder":
        raise not_ported(f"DATA.FORMAT={cfg.DATA.FORMAT!r} (the shards and token "
                         "pipelines)", "Real data and many processes")
    from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset

    # train: RandomResizedCrop to TRAIN.IM_SIZE; val: shorter side to
    # TEST.IM_SIZE, center crop to the model input TRAIN.IM_SIZE
    return ImageFolderDataset(
        cfg.TRAIN.DATASET if train else cfg.TEST.DATASET,
        cfg.TRAIN.SPLIT if train else cfg.TEST.SPLIT,
        im_size=cfg.TRAIN.IM_SIZE if train else cfg.TEST.IM_SIZE, train=train,
        base_seed=cfg.RNG_SEED or 0, crop_size=None if train else cfg.TRAIN.IM_SIZE,
        backend=cfg.DATA.BACKEND, raw_u8=raw_u8)


def construct_train_loader() -> Loader:
    """The train pipeline: shuffled, ``drop_last``."""
    return Loader(_build_dataset(True), cfg.TRAIN.BATCH_SIZE, shuffle=True,
                  drop_last=True, workers=cfg.TRAIN.WORKERS, seed=cfg.RNG_SEED or 0)


def construct_val_loader() -> Loader:
    """The val pipeline: unshuffled, the ragged tail kept and masked."""
    return Loader(_build_dataset(False), cfg.TEST.BATCH_SIZE, shuffle=False,
                  drop_last=False, workers=cfg.TRAIN.WORKERS, seed=cfg.RNG_SEED or 0)
