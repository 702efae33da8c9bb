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
sample is replaced by a good one from its batch and logged
(``FAULTS.DECODE_ERROR_IDX`` injects such a failure, at the JAX package's
two sites).
:func:`device_prefetch` copies the next ``TRAIN.PREFETCH_DEVICE`` batches
to the card (pinned host buffers, ``non_blocking``) while the current step
runs.

Each batch is a dict: ``image`` [B,H,W,3] (uint8 under
``DATA.DEVICE_NORMALIZE``, else float32, NHWC), ``label`` [B] int32,
``mask`` [B] float32, with B the per-process batch; token shards give
``image`` and ``label`` [B, S] int32 (inputs and next tokens).

A dataset may bring its own sampler (``make_sampler``: the shards'
window-shuffled order). Either sampler draws the epoch's global order from
``(seed, epoch)`` alone and strides it by rank, so k global batches
consume the order's first k × global batch samples at any world size. On
that rests the exact mid-epoch resume of the shards format:
:meth:`Loader.state_dict` saves the global cursor and the order's
identity, :meth:`Loader.load_state_dict` checks them against the live
pipeline, and the epoch's next iteration skips the batches already
trained.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.data.sampler import DistributedSampler
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.utils import faults
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
        self.backend = (("native" if use_native() else "pil") if use_native
                        else getattr(dataset, "KIND", "dummy"))
        self.prefetch_depth = 2 if self.backend == "native" else self.workers
        self.retries = max(0, int(cfg.DATA.RETRIES))
        self.retry_backoff = float(cfg.DATA.RETRY_BACKOFF_S)
        self.skip_corrupt = bool(cfg.DATA.SKIP_CORRUPT)
        world, rank = dist.get_world_size(), dist.get_rank()
        make = getattr(dataset, "make_sampler", None)
        self.sampler = make(num_replicas=world, rank=rank, shuffle=shuffle, seed=seed) \
            if make is not None else None
        if self.sampler is None:
            self.sampler = DistributedSampler(len(dataset), num_replicas=world, rank=rank,
                                              shuffle=shuffle, seed=seed)
        self._epoch = 0
        self._resume: dict | None = None  # {"epoch", "skip"}, one-shot

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(epoch)

    def can_save_state(self) -> bool:
        """True when the position is exactly resumable: the shards format
        with an order whose identity can be saved. ImageFolder keeps the
        epoch-granular resume."""
        return (getattr(self.dataset, "FORMAT", "") == "shards"
                and hasattr(self.sampler, "order_state"))

    def state_dict(self, batches_consumed: int) -> dict:
        """The iterator's state after ``batches_consumed`` batches of the
        current epoch: the epoch, the global sample cursor (batches × batch
        × processes: the same meaning at any world size) and the order's
        identity with its generator state. JSON-able, as the JAX
        package's."""
        sd = {
            "v": 1,
            "format": getattr(self.dataset, "FORMAT", "imagefolder"),
            "epoch": int(self._epoch),
            "cursor": int(batches_consumed) * self.batch_size * self.sampler.num_replicas,
            "num_records": len(self.dataset),
        }
        if hasattr(self.sampler, "order_state"):
            sd["order"] = self.sampler.order_state()
        # the token species' pack and tokenizer fingerprint: the same bytes
        # under another tokenizer or pack length are other samples
        if hasattr(self.dataset, "identity"):
            sd["dataset_identity"] = self.dataset.identity()
        return sd

    def load_state_dict(self, sd: dict) -> int:
        """Arms the one-shot skip of a saved :meth:`state_dict`; returns
        the batches of this process the matching epoch will skip. Raises
        ``ValueError`` when the cursor cannot be trusted (another format,
        record count, order identity or dataset identity): the caller
        re-runs the epoch from batch 0. A global batch that grew past a divisor of the cursor
        rounds down, with a warning (those samples train twice)."""
        live_fmt = getattr(self.dataset, "FORMAT", "imagefolder")
        if sd.get("format") != live_fmt:
            raise ValueError(f"saved data state is {sd.get('format')!r}, live pipeline "
                             f"is {live_fmt!r}")
        if int(sd.get("num_records", -1)) != len(self.dataset):
            raise ValueError(f"corpus changed: saved {sd.get('num_records')} records, live "
                             f"dataset has {len(self.dataset)}")
        saved_order = sd.get("order")
        if saved_order is not None:
            if not hasattr(self.sampler, "order_state"):
                raise ValueError("live sampler has no saveable order")
            cur = self.sampler.epoch
            self.sampler.set_epoch(int(sd["epoch"]))
            live_order = self.sampler.order_state()
            self.sampler.set_epoch(cur)
            if live_order != saved_order:
                diff = [k for k in sorted(set(live_order) | set(saved_order))
                        if live_order.get(k) != saved_order.get(k)]
                raise ValueError("shuffle order identity changed since the save (fields: "
                                 f"{', '.join(diff)}): the cursor would point into another "
                                 "permutation")
        saved_ident = sd.get("dataset_identity")
        if saved_ident is not None:
            live_ident = self.dataset.identity() if hasattr(self.dataset, "identity") else None
            if live_ident != saved_ident:
                raise ValueError(
                    f"dataset identity changed since the save (saved "
                    f"{saved_ident}, live {live_ident}) — a tokenizer/"
                    "pack-len drift makes the cursor meaningless"
                )
        cursor = int(sd["cursor"])
        global_batch = self.batch_size * self.sampler.num_replicas
        skip, rem = divmod(cursor, global_batch)
        if rem:
            get_logger().warning("restored cursor %d is not a multiple of the live global "
                                 "batch %d: resuming at batch %d (up to %d samples re-run)",
                                 cursor, global_batch, skip, rem)
        self._resume = {"epoch": int(sd["epoch"]), "skip": int(skip)}
        return int(skip)

    def resume_skip(self, epoch: int) -> int:
        """The batches the next iteration of ``epoch`` skips (armed by
        :meth:`load_state_dict`, consumed by ``__iter__``)."""
        if self._resume is not None and self._resume["epoch"] == int(epoch):
            return self._resume["skip"]
        return 0

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
        def fetch():
            faults.maybe_decode_error(int(i))  # injection hook (FAULTS.DECODE_ERROR_*)
            return self.dataset[int(i)]

        sample, err = self._with_retries(fetch, f"sample {int(i)}")
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
            def fetch():
                for i in idxs:
                    faults.maybe_decode_error(int(i))
                return self.dataset.load_batch(idxs, n_threads=self.workers)

            out, err = self._with_retries(fetch, "batch")
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
        # uint8 under DATA.DEVICE_NORMALIZE, else float32; a dataset may
        # pin the payload dtype (BATCH_DTYPE: the token species' int32 ids,
        # which are neither cast nor normalized)
        img_dtype = getattr(self.dataset, "BATCH_DTYPE", None) or (
            np.uint8 if images.dtype == np.uint8 else np.float32)
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
            # labels are [B] for the image zoo, [B, S] for the LM
            batch["label"] = np.concatenate(
                [batch["label"], np.zeros((pad,) + batch["label"].shape[1:], np.int32)])
            batch["mask"] = np.concatenate([batch["mask"], np.zeros(pad, np.float32)])
        return batch

    def __iter__(self):
        idxs = self.sampler.indices()
        chunks = [idxs[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        if self._resume is not None and self._resume["epoch"] == self._epoch:
            # the exact mid-epoch resume: the preempted run trained these
            chunks = chunks[self._resume["skip"]:]
            self._resume = None
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
    if cfg.DATA.FORMAT == "tokens":
        # the LM's packed token shards (data/shards/tokens.py); the pack
        # length and the tokenizer and vocab identity are checked here
        from distribuuuu_tpu_torch.data.shards.tokens import TokenShardDataset

        return TokenShardDataset(cfg.TRAIN.DATASET if train else cfg.TEST.DATASET,
                                 cfg.TRAIN.SPLIT if train else cfg.TEST.SPLIT,
                                 seq_len=int(cfg.LM.SEQ_LEN),
                                 num_classes=int(cfg.MODEL.NUM_CLASSES))
    if cfg.DATA.FORMAT == "shards":
        from distribuuuu_tpu_torch.data.shards.reader import ShardDataset as Dataset
    elif cfg.DATA.FORMAT == "imagefolder":
        from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset as Dataset
    else:
        raise ValueError(f"DATA.FORMAT must be imagefolder|shards|tokens, got "
                         f"{cfg.DATA.FORMAT!r}")
    # train: RandomResizedCrop to TRAIN.IM_SIZE; val: shorter side to
    # TEST.IM_SIZE, center crop to the model input TRAIN.IM_SIZE. A shards
    # DATASET is the packed root (<split>/MANIFEST.json)
    return Dataset(
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
