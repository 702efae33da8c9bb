"""Orbax checkpoints read without JAX, orbax or tensorstore.

The JAX package saves with ``orbax.checkpoint.PyTreeCheckpointer`` (its
full ``ckpt_ep_NNN`` saves and the weights-only ``best``), or, on the
cross-host async path, as ``SHARDS_host<r>.json`` plus
``shards_host<r>.npz``. :func:`read_checkpoint` reads either into nested
dicts of numpy arrays, as ``distribuuuu_tpu.utils.checkpoint.
load_checkpoint`` returns them (``bfloat16`` leaves widened to f32
bitwise), decoding only the top-level entries it is asked for.

What the reader knows of the orbax layout (orbax 0.11 over tensorstore's
OCDBT key-value store; the bytes of a save of a toy tree show each point):

* ``_METADATA`` is JSON: ``use_ocdbt``, ``use_zarr3`` (false: zarr v2)
  and ``tree_metadata``, one entry a leaf, keyed like
  ``"('params', 'conv', 'kernel')"``, whose ``key_metadata`` lists the
  path. The leaf's zarr array sits at the key ``params.conv.kernel``:
  ``params.conv.kernel/.zarray`` (JSON: ``shape``, ``chunks``, ``dtype``
  such as ``"<f4"`` or ``"bfloat16"``, ``compressor`` ``{"id": "zstd"}``
  or null, ``order`` ``"C"``, ``fill_value``) and one value a chunk,
  ``params.conv.kernel/0.0.0`` (a scalar: ``0``), a chunk always whole
  (edge chunks padded). A string leaf is not an array: its value sits in
  ``_strings.json`` under the same name.
* With OCDBT the keys live in a key-value store whose root is the
  checkpoint directory. Every manifest and B-tree node is an envelope: a
  4-byte big-endian magic (``0c db 3a 2a`` manifest, ``0c db 20 de``
  node), its own length (u64 little-endian), a varint version (0), a
  varint compression (0 none, 1 zstd: the rest is one zstd frame) and a
  CRC-32C (little-endian) of everything before it.
* ``manifest.ocdbt``: the config (a 16-byte uuid; varints manifest kind,
  0 = single, the only one orbax writes; max inline value bytes; max
  decoded node bytes; a u8 version-tree arity log2; varint compression
  and, for zstd, its level; three varint-length-prefixed data-file
  prefixes), a data file table, then the inline versions column by
  column: count, generations, root heights (u8), the root's data file,
  offset and length, key, tree-byte and indirect-byte counts, commit times
  (u64). The newest generation is the tree to read.
* A data file table: count, the shared-prefix length of each path after
  the first, each path's suffix length, each base-path length, then the
  suffixes; a path is relative to the root (orbax's merged root points
  into ``ocdbt.process_0/d/``).
* A node: height (u8), its data file table, the entry count, each key's
  shared-prefix length after the first and its suffix length; an
  interior node (height > 0) then each child's common-prefix length;
  then the key suffixes. A leaf then has each value's length and kind (0
  inline, 1 in a data file), the data file and offset of each indirect
  value, and the inline values back to back. An interior node has each
  child's data file, offset, length and key, byte and indirect-byte
  counts; a child's keys drop the parent's key prefix and the child's
  common prefix.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# a full training save's entries that MODEL.WEIGHTS needs
WEIGHT_KEYS = ("params", "batch_stats")
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
           "|u1": np.uint8}
# the value types of an empty subtree (a GPT's batch_stats)
_EMPTY = {"Dict": dict}


class OrbaxFormatError(ValueError):
    """The directory is not an orbax checkpoint this reader can read."""


# -- CRC-32C (Castagnoli), the envelopes' checksum -----------------------------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# -- the OCDBT envelope and its fields ------------------------------------------

class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OrbaxFormatError(f"{self.what}: truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint overflow")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _envelope(raw: bytes, magic: int, what: str) -> _Reader:
    """The body of one manifest or node envelope, its length and CRC
    checked and its zstd frame decoded."""
    if len(raw) < 18:
        raise OrbaxFormatError(f"{what}: {len(raw)} bytes is too short for an OCDBT envelope")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OrbaxFormatError(f"{what}: magic {got_magic:08x}, expected {magic:08x}")
    if length != len(raw):
        raise OrbaxFormatError(f"{what}: envelope says {length} bytes, read {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    if r.varint() != 0:
        raise OrbaxFormatError(f"{what}: unknown envelope version")
    comp = r.varint()
    body = raw[r.pos:-4]
    if comp == 1:
        from distribuuuu_tpu_torch.utils import zstd

        body = zstd.decompress(body)
    elif comp != 0:
        raise OrbaxFormatError(f"{what}: unknown compression {comp}")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> list[str]:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # base-path lengths: the joined path is what locates the file
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode("utf-8"))
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The keys of an OCDBT database rooted at ``root`` (its newest
    version), read from the manifest and the B-tree once; values are read
    on :meth:`get`."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise OrbaxFormatError(f"{root}: _METADATA says OCDBT but there is no manifest.ocdbt")
        with open(path, "rb") as f:
            r = _envelope(f.read(), MANIFEST_MAGIC, path)
        r.take(16)  # uuid
        if r.varint() != 0:
            raise OrbaxFormatError(f"{path}: a numbered manifest (orbax writes a single one)")
        r.varint(), r.varint(), r.u8()  # max inline bytes, max node bytes, arity log2
        if r.varint() == 1:
            r.varint()  # zstd level
        for _ in range(3):  # data file prefixes
            r.take(r.varint())
        files = _data_file_table(r)
        n = r.varint()
        gens = r.varints(n)
        heights = [r.u8() for _ in range(n)]
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self._entries: dict[bytes, object] = {}
        if not n:
            return
        v = max(range(n), key=gens.__getitem__)
        if lengths[v]:
            self._walk(files[file_ids[v]], offsets[v], lengths[v], heights[v], b"")

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(length)
        if len(raw) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes at {offset} run past the file")
        return raw

    def _walk(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.root, rel)}@{offset}"
        r = _envelope(self._read(rel, offset, length), NODE_MAGIC, what)
        if r.u8() != height:
            raise OrbaxFormatError(f"{what}: node height differs from its reference")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for k, c, i, o, ln in zip(keys, common, ids, offs, lens):
                self._walk(files[i], o, ln, height - 1, prefix + k[:c])
            return
        lens, kinds = r.varints(n), r.varints(n)
        m = sum(1 for k in kinds if k == 1)
        ids, offs = r.varints(m), r.varints(m)
        j = 0
        for key, ln, kind in zip(keys, lens, kinds):
            if kind == 0:
                self._entries[prefix + key] = r.take(ln)
            elif kind == 1:
                self._entries[prefix + key] = (files[ids[j]], offs[j], ln)
                j += 1
            else:
                raise OrbaxFormatError(f"{what}: unknown value kind {kind}")

    def keys(self) -> list[str]:
        return [k.decode("utf-8") for k in self._entries]

    def get(self, key: str) -> bytes | None:
        v = self._entries.get(key.encode("utf-8"))
        if v is None or isinstance(v, bytes):
            return v
        return self._read(*v)


# -- zarr v2 arrays -------------------------------------------------------------

def _np_dtype(name):
    if name == "bfloat16":
        return np.dtype(np.uint16)  # the bit pattern, widened below
    if isinstance(name, str) and name in _DTYPES:
        return np.dtype(_DTYPES[name])
    raise OrbaxFormatError(f"zarr dtype {name!r} is not one the reader knows")


def read_zarr(store, name: str) -> np.ndarray:
    """The array at ``name`` (``params.conv.kernel``) of ``store``."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{store.root}: no {name}/.zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format", 2) != 2 or meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr format or filters the reader does not know")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r} (the reader knows zstd)")
    dtype = _np_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    out = np.full(shape, fill if meta["dtype"] != "bfloat16" else 0, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid) if shape else [()]:
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = store.get(f"{name}/{key}")
        if data is None:
            continue  # a chunk equal to the fill value may be left unwritten
        if comp is not None:
            from distribuuuu_tpu_torch.utils import zstd

            data = zstd.decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{name}/{key}: {len(data)} bytes, expected {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = block[tuple(slice(0, t.stop - t.start) for t in sel)]
    if meta["dtype"] == "bfloat16":
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


# -- the checkpoint ---------------------------------------------------------------

def _insert(root: dict, path: list, value) -> None:
    node = root
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _leaf_path(entry: dict) -> list:
    return [str(k["key"]) for k in entry["key_metadata"]]


def sharded_layout_present(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "SHARDS_host0.json"))


def read_sharded(path: str, keys=None) -> dict:
    """The ``SHARDS_host<r>.json`` / ``shards_host<r>.npz`` layout of the
    cross-host async save, reassembled; a shard-count mismatch is refused
    as the JAX package refuses it."""
    with open(os.path.join(path, "SHARDS_host0.json")) as f:
        l0 = json.load(f)
    hosts = int(l0["hosts"])
    names = [f"SHARDS_host{r}.json" for r in range(hosts)] + [
        f"shards_host{r}.npz" for r in range(hosts)]
    missing = [n for n in names if not os.path.isfile(os.path.join(path, n))]
    if missing:
        raise OrbaxFormatError(
            f"sharded checkpoint {path} records hosts={hosts} in SHARDS_host0.json but "
            f"{len(missing)} file(s) are missing: {', '.join(missing)}; refusing to "
            "restore a partial tree")
    leaves = l0["leaves"]
    want = [keys is None or sp["path"][0] in keys for sp in leaves]
    arrays = [None if sp["dtype"] == "utf8" or not w
              else np.empty(tuple(sp["shape"]), _shard_dtype(sp["dtype"]))
              for sp, w in zip(leaves, want)]
    covered = [0] * len(leaves)
    for r in range(hosts):
        with open(os.path.join(path, f"SHARDS_host{r}.json")) as f:
            lay = json.load(f)
        if lay["leaves"] != leaves:
            raise OrbaxFormatError(f"sharded checkpoint {path}: SHARDS_host{r}.json records "
                                   "a different tree than SHARDS_host0.json")
        with np.load(os.path.join(path, f"shards_host{r}.npz")) as z:
            for m in lay["shards"]:
                if not want[m["leaf"]]:
                    continue
                raw = z[m["key"]].tobytes()
                if m["dtype"] == "utf8":
                    arrays[m["leaf"]] = raw.decode("utf-8")
                    covered[m["leaf"]] = 1
                    continue
                arr = np.frombuffer(raw, _shard_dtype(m["dtype"])).reshape(tuple(m["shape"]))
                arrays[m["leaf"]][tuple(slice(a, b) for a, b in m["index"])] = arr
                covered[m["leaf"]] += arr.size
    root: dict = {}
    for sp, arr, n, w in zip(leaves, arrays, covered, want):
        if not w:
            continue
        total = int(np.prod(sp["shape"], dtype=np.int64)) if sp["shape"] else 1
        if sp["dtype"] != "utf8" and n < total:
            raise OrbaxFormatError(f"sharded checkpoint {path}: leaf {'/'.join(sp['path'])} "
                                   f"covered {n}/{total} elements by the recorded shards")
        if sp["dtype"] == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        _insert(root, sp["path"], arr)
    return root


def _shard_dtype(name: str):
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def read_checkpoint(path: str, keys=None) -> dict:
    """The tree of the orbax (or sharded) checkpoint directory ``path`` as
    nested dicts of numpy arrays; only the top-level entries in ``keys``
    are decoded (None: all). Raises :class:`OrbaxFormatError` naming what
    is missing or unreadable."""
    if not os.path.isdir(path):
        raise OrbaxFormatError(f"{path} is not a directory")
    if sharded_layout_present(path):
        return read_sharded(path, keys)
    mpath = os.path.join(path, "_METADATA")
    if not os.path.isfile(mpath):
        raise OrbaxFormatError(
            f"{path}: no _METADATA (not an orbax PyTree checkpoint, or one written by an "
            "orbax older than the reader knows)")
    with open(mpath) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise OrbaxFormatError(f"{path}: a zarr v3 or non-OCDBT checkpoint (the reader knows "
                               "orbax's default, OCDBT over zarr v2)")
    store = OcdbtStore(path)
    strings = None
    root: dict = {}
    for key, entry in meta["tree_metadata"].items():
        lpath = _leaf_path(entry)
        if keys is not None and lpath[0] not in keys:
            continue
        name = ".".join(str(p) for p in lpath)
        vtype = (entry.get("value_metadata") or {}).get("value_type", "")
        if vtype == "string":  # strings sit in one JSON file, by zarr name
            if strings is None:
                with open(os.path.join(path, "_strings.json")) as f:
                    strings = json.load(f)
            _insert(root, lpath, strings[name])
        elif vtype in ("np.ndarray", "jax.Array", "scalar"):
            arr = read_zarr(store, name)
            # orbax gives a scalar back as a Python number
            _insert(root, lpath, arr[()].item() if vtype == "scalar" else arr)
        elif vtype in _EMPTY:
            _insert(root, lpath, _EMPTY[vtype]())
        else:
            raise OrbaxFormatError(f"{path}: leaf {key} has value type {vtype!r}")
    return root
