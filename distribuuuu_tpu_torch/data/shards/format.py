"""The image shards format (counterpart of distribuuuu_tpu/data/shards/format.py).

Record shards of a fixed target size, each with an index footer, and a
``MANIFEST.json`` per split committed last. An ImageFolder costs one
``open`` + ``read`` a JPEG (about 1.3M an ImageNet epoch); a packed split
is a few large files read with positioned reads. The on-disk contract is
the JAX package's, byte for byte (``dtpu-rec-v1``, manifest schema 1,
trailer magic ``DTPUSHD1``): a pack either package writes, the other
reads, and the same tree packed by both at the same ``target_bytes`` gives
the same shard files and manifests equal but for ``source``.

Layout of ``<out>/<split>/``::

  shard-00000.drec … shard-NNNNN.drec   record shards (SHARD_PATTERN)
  MANIFEST.json                         the split's manifest (written last)

A shard file is its records, then an index footer::

  record  := <u32 body_len> <u32 crc32(body)> body
  body    := <i32 label> <u16 key_len> key-utf8 image-bytes
  index   := n_records × <u64 record_offset>
  trailer := <u64 index_offset> <u32 n_records> <u32 crc32(index)> 8s magic

The image bytes are the source file's encoded bytes as they are, so a
packed sample decodes exactly as its source file does. Each record has
its own CRC: a flipped bit or a lost tail raises :class:`ShardReadError`
for that sample alone, which the loader's ``DATA.SKIP_CORRUPT`` turns
into a logged substitution. A shard whose footer is damaged is re-indexed
by a forward scan over its records (:func:`read_shard_index`).

``MANIFEST.json`` is committed by tmp file + fsync + ``os.replace`` after
every shard is durable: without it the pack never finished. It holds the
per-shard record counts, sizes and sha256 digests (:func:`verify_split`
re-reads everything against them) and the class list.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

from distribuuuu_tpu_torch.resilience.manifest import sha256_file

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_SCHEMA = 1
RECORD_FORMAT = "dtpu-rec-v1"
SHARD_PATTERN = "shard-{:05d}.drec"
TRAILER_MAGIC = b"DTPUSHD1"

_HEADER = struct.Struct("<II")       # body_len, crc32(body)
_BODY_FIXED = struct.Struct("<iH")   # label, key_len
_TRAILER = struct.Struct("<QII8s")   # index_offset, n_records, crc32, magic
_OFFSET = struct.Struct("<Q")

DEFAULT_SHARD_BYTES = 64 * 1024 * 1024


class ShardFormatError(RuntimeError):
    """The split itself is unusable (no manifest, an unfinished pack, a
    schema or species mismatch): a corpus problem, not a record's."""


class ShardReadError(RuntimeError):
    """One record could not be read (CRC mismatch, lost to truncation);
    the loader's retry and skip path handles it per sample."""


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# ------------------------------------------------------------------ writing


def encode_record(image_bytes: bytes, label: int, key: str) -> bytes:
    kb = key.encode("utf-8")
    if len(kb) > 0xFFFF:
        raise ValueError(f"record key too long ({len(kb)} bytes): {key[:80]}…")
    body = _BODY_FIXED.pack(int(label), len(kb)) + kb + image_bytes
    return _HEADER.pack(len(body), _crc(body)) + body


def decode_record(body: bytes) -> tuple[bytes, int, str]:
    """A record's body (its CRC already checked) → ``(image_bytes, label,
    key)``."""
    label, key_len = _BODY_FIXED.unpack_from(body, 0)
    off = _BODY_FIXED.size
    key = body[off:off + key_len].decode("utf-8")
    return body[off + key_len:], int(label), key


class ShardWriter:
    """Appends records, rolling to a new shard once the current one
    reaches ``target_bytes`` (a record is never split). ``close()``
    returns the per-shard metadata for the manifest; every shard is
    fsynced as it is finished."""

    def __init__(self, out_dir: str, target_bytes: int = DEFAULT_SHARD_BYTES):
        if target_bytes <= 0:
            raise ValueError(f"target_bytes must be positive, got {target_bytes}")
        self.out_dir = out_dir
        self.target_bytes = int(target_bytes)
        os.makedirs(out_dir, exist_ok=True)
        self.shards: list[dict] = []
        self._f = None
        self._offsets: list[int] = []

    def _open_next(self) -> None:
        name = SHARD_PATTERN.format(len(self.shards))
        self.shards.append({"file": name, "records": 0})
        self._offsets = []
        self._f = open(os.path.join(self.out_dir, name), "wb")

    def _finish_shard(self) -> None:
        if self._f is None:
            return
        index = b"".join(_OFFSET.pack(o) for o in self._offsets)
        index_offset = self._f.tell()
        self._f.write(index)
        self._f.write(_TRAILER.pack(index_offset, len(self._offsets), _crc(index),
                                    TRAILER_MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())
        size = self._f.tell()
        self._f.close()
        self.shards[-1]["records"] = len(self._offsets)
        self.shards[-1]["size"] = size
        self._f = None

    def add(self, image_bytes: bytes, label: int, key: str) -> None:
        if self._f is None:
            self._open_next()
        self._offsets.append(self._f.tell())
        self._f.write(encode_record(image_bytes, label, key))
        if self._f.tell() >= self.target_bytes:
            self._finish_shard()

    def close(self) -> list[dict]:
        self._finish_shard()
        return self.shards


def write_shard_manifest(split_dir: str, shards: list[dict], classes: list[str],
                         target_bytes: int, source: str = "",
                         extra: dict | None = None) -> str:
    """The commit marker of a finished pack, written after every shard is
    durable, with each shard's sha256. ``extra`` merges a species' own
    fields (the token species declares ``kind="tokens"``); an image pack
    has no ``kind``, which readers take as ``"images"``."""
    for s in shards:
        s["sha256"] = sha256_file(os.path.join(split_dir, s["file"]))
    man = {
        "schema": MANIFEST_SCHEMA,
        "record_format": RECORD_FORMAT,
        "num_records": sum(s["records"] for s in shards),
        "classes": list(classes),
        "target_shard_bytes": int(target_bytes),
        "shards": shards,
        "source": source,
        **(extra or {}),
    }
    dest = os.path.join(split_dir, MANIFEST_NAME)
    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dest)
    return dest


def read_shard_manifest(split_dir: str) -> dict:
    path = os.path.join(split_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            man = json.load(f)
    except FileNotFoundError:
        raise ShardFormatError(
            f"no {MANIFEST_NAME} under {split_dir}: not a packed shard split (or the "
            "pack was interrupted before its commit). Pack with: python -m "
            "distribuuuu_tpu_torch.data.shards.pack --src <imagefolder-root> --out "
            f"{os.path.dirname(split_dir) or '<shards-root>'}") from None
    except (OSError, json.JSONDecodeError) as e:
        raise ShardFormatError(f"unreadable {path}: {e}") from e
    if man.get("schema") != MANIFEST_SCHEMA or man.get("record_format") != RECORD_FORMAT:
        raise ShardFormatError(
            f"{path}: schema/format {man.get('schema')}/{man.get('record_format')} not "
            f"supported (want {MANIFEST_SCHEMA}/{RECORD_FORMAT})")
    return man


def pack_imagefolder(src_root: str, out_root: str, splits=("train", "val"),
                     target_bytes: int = DEFAULT_SHARD_BYTES, progress=None) -> dict:
    """Packs ``src_root/<split>/<class>/*`` into shards under
    ``out_root/<split>/``, in ``scan_image_folder`` order: record i of a
    split is sample i of ``ImageFolderDataset`` over the same tree.
    Returns ``{split: manifest_path}``."""
    from distribuuuu_tpu_torch.data.imagefolder import scan_image_folder

    out = {}
    for split in splits:
        samples, classes = scan_image_folder(os.path.join(src_root, split))
        split_dir = os.path.join(out_root, split)
        writer = ShardWriter(split_dir, target_bytes=target_bytes)
        for i, (path, label) in enumerate(samples):
            with open(path, "rb") as f:
                image_bytes = f.read()
            writer.add(image_bytes, label, os.path.relpath(path, os.path.join(src_root, split)))
            if progress is not None and (i + 1) % 1000 == 0:
                progress(split, i + 1, len(samples))
        out[split] = write_shard_manifest(split_dir, writer.close(), classes, target_bytes,
                                          source=os.path.abspath(src_root))
    return out


# ------------------------------------------------------------------ reading


def read_shard_index(path: str) -> tuple[list[int], bool]:
    """One shard's record offsets: ``(offsets, recovered)``. The footer
    when it is intact; otherwise a forward scan from offset 0 keeps every
    record that is whole and CRC-clean (``recovered`` True: the caller
    logs it), so a truncated shard still serves what precedes the cut.
    Raises :class:`ShardFormatError` only when the file cannot be read."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size >= _TRAILER.size:
                f.seek(size - _TRAILER.size)
                index_offset, n, crc, magic = _TRAILER.unpack(f.read(_TRAILER.size))
                if (magic == TRAILER_MAGIC
                        and index_offset + n * _OFFSET.size + _TRAILER.size == size):
                    f.seek(index_offset)
                    index = f.read(n * _OFFSET.size)
                    if _crc(index) == crc:
                        return [_OFFSET.unpack_from(index, i * _OFFSET.size)[0]
                                for i in range(n)], False
            offsets, pos = [], 0
            while pos + _HEADER.size <= size:
                f.seek(pos)
                body_len, crc = _HEADER.unpack(f.read(_HEADER.size))
                end = pos + _HEADER.size + body_len
                if end > size:
                    break  # the record runs past the end: the truncation point
                if _crc(f.read(body_len)) != crc:
                    break  # a damaged record, or the start of the footer
                offsets.append(pos)
                pos = end
            return offsets, True
    except OSError as e:
        raise ShardFormatError(f"cannot read shard {path}: {e}") from e


def read_record_at(fd: int, offset: int, path: str = "?") -> tuple[bytes, int, str]:
    """One record by ``os.pread`` (no shared file position, so reader
    threads need no lock). Raises :class:`ShardReadError` on truncation or
    a CRC mismatch."""
    header = os.pread(fd, _HEADER.size, offset)
    if len(header) < _HEADER.size:
        raise ShardReadError(f"{path}@{offset}: record header truncated "
                             f"({len(header)}/{_HEADER.size} bytes)")
    body_len, crc = _HEADER.unpack(header)
    body = os.pread(fd, body_len, offset + _HEADER.size)
    if len(body) < body_len:
        raise ShardReadError(f"{path}@{offset}: record body truncated "
                             f"({len(body)}/{body_len} bytes)")
    if _crc(body) != crc:
        raise ShardReadError(f"{path}@{offset}: record CRC mismatch")
    return decode_record(body)


def verify_split(split_dir: str) -> tuple[bool, list[str]]:
    """Certifies a packed split against its manifest: each shard's size
    and sha256, its index footer, every record's CRC, and the record
    counts. ``(ok, problems)``."""
    try:
        man = read_shard_manifest(split_dir)
    except ShardFormatError as e:
        return False, [str(e)]
    problems: list[str] = []
    total = 0
    for meta in man["shards"]:
        path = os.path.join(split_dir, meta["file"])
        if not os.path.isfile(path):
            problems.append(f"{meta['file']}: missing")
            continue
        size = os.path.getsize(path)
        if size != meta["size"]:
            problems.append(f"{meta['file']}: size {size} != manifest {meta['size']}")
            continue
        if sha256_file(path) != meta["sha256"]:
            problems.append(f"{meta['file']}: sha256 mismatch")
            continue
        offsets, recovered = read_shard_index(path)
        if recovered:
            problems.append(f"{meta['file']}: index footer unreadable")
            continue
        if len(offsets) != meta["records"]:
            problems.append(f"{meta['file']}: {len(offsets)} records != manifest "
                            f"{meta['records']}")
            continue
        fd = os.open(path, os.O_RDONLY)
        try:
            for off in offsets:
                read_record_at(fd, off, path)
        except ShardReadError as e:
            problems.append(str(e))
        finally:
            os.close(fd)
        total += meta["records"]
    if not problems and total != man["num_records"]:
        problems.append(f"total records {total} != manifest num_records "
                        f"{man['num_records']}")
    return not problems, problems
