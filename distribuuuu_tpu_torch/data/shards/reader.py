"""Readers of a packed shard split (counterpart of
distribuuuu_tpu/data/shards/reader.py).

:class:`RecordShards` is the species-independent core: the manifest, the
global index → (shard, record) map, each shard's descriptor and index
opened lazily under a lock, and the lockless positioned record read.
:class:`ShardDataset` is the image species on it, with the surface the
loader speaks for ImageFolder (``__len__``, ``__getitem__``,
``load_batch``, ``set_epoch_seed``, ``classes``) plus ``make_sampler``,
which gives training the window-shuffled sequential order of
``order.py``. The token species rides on the same core (ROADMAP "LM
plane").

A packed record holds its source file's bytes, and a sample's
augmentation draws from the same ``SeedSequence([RNG_SEED, epoch,
index])`` as ``ImageFolderDataset``: sample i of a packed split decodes
exactly as sample i of its source tree. ``load_batch`` decodes through
the native decoder's in-memory entry points (``native.load_batch_mem``)
and redoes through PIL an image the decoder cannot take; with
``DATA.BACKEND auto`` on a host where the decoder does not build it is
PIL throughout. A damaged record raises ``ShardReadError`` for its sample
alone (the loader's ``DATA.SKIP_CORRUPT`` path); a shard whose footer is
lost is re-indexed by a forward scan when it is opened, with a warning
that gives the recovered and expected counts (``FAULTS.TRUNCATE_SHARD``
drills it). Every record read adds to the registry's ``shards.records``
and ``shards.bytes``.
"""

from __future__ import annotations

import io
import os
import threading

import numpy as np

from distribuuuu_tpu_torch.data import transforms as T
from distribuuuu_tpu_torch.data.shards.format import (
    ShardFormatError,
    ShardReadError,
    read_record_at,
    read_shard_index,
    read_shard_manifest,
)
from distribuuuu_tpu_torch.telemetry import registry as telemetry_registry

BACKENDS = ("auto", "native", "pil")


class RecordShards:
    """Manifest, index map and record reads of one split (module
    docstring); a species subclass sets ``KIND`` and decodes."""

    FORMAT = "shards"
    KIND = "images"  # the manifest species this reader decodes; absent reads as images
    PACKER = "python -m distribuuuu_tpu_torch.data.shards.pack"

    def _open_split(self, root: str, split: str) -> None:
        from distribuuuu_tpu_torch.utils import faults

        self.dir = os.path.join(root, split)
        faults.maybe_truncate_shard(self.dir)  # a no-op unless FAULTS.TRUNCATE_SHARD
        self.manifest = read_shard_manifest(self.dir)
        kind = self.manifest.get("kind", "images")
        if kind != self.KIND:
            raise ShardFormatError(
                f"{self.dir} holds {kind!r} shards but DATA.FORMAT selects the "
                f"{self.KIND!r} reader: point TRAIN/TEST.DATASET at a {self.KIND} pack "
                f"({self.PACKER} writes one) or switch DATA.FORMAT")
        self._shards = self.manifest["shards"]
        counts = [int(s["records"]) for s in self._shards]
        self._cum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._n = int(self.manifest["num_records"])
        self._open_lock = threading.Lock()
        self._fds: dict[int, int] = {}
        self._offsets: dict[int, list[int]] = {}
        # the records and encoded bytes this reader read (the registry's
        # shards.records / shards.bytes count every reader of the process)
        self._tally_lock = threading.Lock()
        self.records_read = 0
        self.bytes_read = 0

    def _shard_of(self, idx: int) -> tuple[int, int]:
        if not 0 <= idx < self._n:
            raise IndexError(f"sample {idx} out of range [0, {self._n})")
        s = int(np.searchsorted(self._cum, idx, side="right")) - 1
        return s, idx - int(self._cum[s])

    def _ensure_open(self, s: int) -> tuple[int, list[int]]:
        with self._open_lock:
            if s not in self._fds:
                from distribuuuu_tpu_torch.utils.logger import get_logger

                path = os.path.join(self.dir, self._shards[s]["file"])
                offsets, recovered = read_shard_index(path)
                expect = int(self._shards[s]["records"])
                if recovered or len(offsets) != expect:
                    get_logger().warning(
                        "shard %s: index footer unreadable: recovered %d of %d records by "
                        "forward scan; the lost records raise and go through the "
                        "DATA.SKIP_CORRUPT path", path, len(offsets), expect)
                self._fds[s] = os.open(path, os.O_RDONLY)
                self._offsets[s] = offsets
            return self._fds[s], self._offsets[s]

    def record(self, idx: int) -> tuple[bytes, int, str]:
        """The raw record ``(image_bytes, label, key)``."""
        s, r = self._shard_of(int(idx))
        fd, offsets = self._ensure_open(s)
        if r >= len(offsets):
            raise ShardReadError(
                f"sample {idx}: record {r} of {self._shards[s]['file']} lost to truncation "
                f"(the shard has {len(offsets)} readable records, the manifest says "
                f"{self._shards[s]['records']})")
        rec = read_record_at(fd, offsets[r], self._shards[s]["file"])
        with self._tally_lock:
            self.records_read += 1
            self.bytes_read += len(rec[0])
        reg = telemetry_registry.get_registry()
        reg.counter("shards.records").inc(1)
        reg.counter("shards.bytes").inc(len(rec[0]))
        return rec

    def close(self) -> None:
        with self._open_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
            self._offsets.clear()

    def __len__(self):
        return self._n

    def set_epoch_seed(self, seed: int) -> None:
        self._epoch_seed = seed

    def make_sampler(self, num_replicas: int, rank: int, shuffle: bool, seed: int,
                     drop_last: bool = False):
        """The loader's sampler hook: training gets the window-shuffled
        sequential order (``DATA.SHARDS_BLOCK``, ``DATA.SHARDS_WINDOW``);
        eval None, the loader's unshuffled ``DistributedSampler``."""
        if not shuffle:
            return None
        from distribuuuu_tpu_torch.config import cfg
        from distribuuuu_tpu_torch.data.shards.order import WindowShuffleSampler

        return WindowShuffleSampler(self._n, num_replicas, rank, seed=seed,
                                    block=int(cfg.DATA.SHARDS_BLOCK),
                                    window=int(cfg.DATA.SHARDS_WINDOW), drop_last=drop_last)


class ShardDataset(RecordShards):
    """The image species: encoded image bytes a record, decoded through
    the native decoder's in-memory entry points or PIL, as
    ``DATA.BACKEND`` says (``auto``: native when it builds, else PIL;
    ``native`` raises without it; ``pil``)."""

    def __init__(self, root: str, split: str, im_size: int, train: bool, base_seed: int = 0,
                 crop_size: int | None = None, backend: str = "auto", raw_u8: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"DATA.BACKEND must be auto|native|pil, got {backend}")
        self._open_split(root, split)
        self.classes = list(self.manifest["classes"])
        self.im_size = im_size
        self.crop_size = im_size if crop_size is None else crop_size
        self.train = train
        self.base_seed = base_seed
        self._epoch_seed = 0
        self.backend = backend
        self.raw_u8 = raw_u8

    def _rng(self, idx: int) -> np.random.Generator:
        # ImageFolderDataset._rng's stream: the same (seed, epoch, index)
        return np.random.default_rng(
            np.random.SeedSequence([self.base_seed, self._epoch_seed, idx]))

    def _use_native(self) -> bool:
        if self.backend == "pil":
            return False
        from distribuuuu_tpu_torch import native

        if native.available() and native.has_mem_api():
            return True
        if self.backend == "native":
            raise RuntimeError("DATA.BACKEND=native but the native decoder (with the "
                               "in-memory entry points shards need) is unavailable: "
                               f"{native.build_error()}")
        return False

    def _decode_pil(self, image_bytes: bytes, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(io.BytesIO(image_bytes)) as img:
            img = img.convert("RGB")
            if self.train:
                return T.train_transform(img, self.im_size, self._rng(idx),
                                         normalize=not self.raw_u8)
            return T.val_transform(img, self.im_size, self.crop_size,
                                   normalize=not self.raw_u8)

    def __getitem__(self, idx: int):
        image_bytes, label, _ = self.record(int(idx))
        return self._decode_pil(image_bytes, int(idx)), label

    def load_batch(self, idxs, n_threads: int = 4):
        """``(images [n, H, W, 3], labels [n] int32)`` of the samples
        ``idxs``: one call into the native decoder over ``n_threads``
        threads on the records' bytes, with PIL redoing each image it
        could not take; or PIL image by image."""
        out_size = self.im_size if self.train else self.crop_size
        recs = [self.record(int(i)) for i in idxs]
        labels = np.asarray([r[1] for r in recs], np.int32)
        out_dtype = np.uint8 if self.raw_u8 else np.float32
        if not self._use_native():
            images = np.stack([self._decode_pil(rec[0], int(i)) for rec, i in zip(recs, idxs)])
            return images.astype(out_dtype), labels

        from distribuuuu_tpu_torch import native

        geoms = np.zeros((len(recs),), native.GEOM_DTYPE)
        bufs: list[bytes] = []
        fallback: list[int] = []
        for pos, (rec, idx) in enumerate(zip(recs, (int(i) for i in idxs))):
            dims = native.mem_dims(rec[0])
            if dims is None:  # a format the decoder does not read: PIL
                bufs.append(b"")  # fails in the decoder at once
                fallback.append(pos)
                continue
            bufs.append(rec[0])
            if self.train:
                g = T.train_geom(*dims, self.im_size, self._rng(idx))
            else:
                g = T.val_geom(*dims, self.im_size, self.crop_size)
            geoms[pos] = g + (0,)
        if self.raw_u8:
            images, statuses = native.load_batch_u8_mem(bufs, geoms, (out_size, out_size),
                                                        n_threads)
        else:
            images, statuses = native.load_batch_mem(bufs, geoms, (out_size, out_size),
                                                     T.IMAGENET_MEAN, T.IMAGENET_STD,
                                                     n_threads)
        for pos in set(fallback) | set(np.nonzero(statuses)[0].tolist()):
            images[pos] = self._decode_pil(recs[pos][0], int(idxs[pos]))
        return images, labels
