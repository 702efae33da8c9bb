"""Checkpoint manifests (counterpart of distribuuuu_tpu/resilience/manifest.py).

The port keeps one ``torch.save`` file a checkpoint (``ckpt_ep_NNN.pth``,
``preempt_ep_NNN.pth``, ``best.pth``). Its commit marker is a JSON sidecar
beside it, ``<name>.pth.manifest.json``, written through a temporary file
and ``os.replace`` strictly after the payload's own rename. It records the
payload's size and sha256, the epoch, the kind (``full`` or ``weights``),
the arch fingerprint and the tree spec (key path → shape and dtype).

A sharded save (a ZeRO run's background save across processes) is a
directory ``ckpt_ep_NNN/`` in the JAX package's layout, and its manifest
is ``MANIFEST.json`` inside it, as the JAX package writes it: every file
of the directory (each process's ``shards_host<r>.npz`` and
``SHARDS_host<r>.json``) with its size and sha256, and a ``sharded``
record (the number of processes and their shard files).

No manifest ⇒ the save never completed ⇒ the checkpoint is invalid. A
manifest whose size or digest disagrees with a file, or a file it names
that is gone ⇒ corrupt. ``utils/checkpoint.find_last_valid_checkpoint``
walks back over both, quarantining them. Either form holds full tensors
by name (a sharded save's shards cover each leaf), so a resume at another
world size or ZeRO stage loads it as it is.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

from distribuuuu_tpu_torch.config import cfg

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_NAME = "MANIFEST.json"  # inside a sharded save's directory
MANIFEST_SCHEMA = 1


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming file digest."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while b := f.read(chunk):
            h.update(b)
    return h.hexdigest()


def config_fingerprint() -> str:
    """Digest of the config keys that determine the parameter tree (arch,
    classes, MoE), as the JAX package computes it."""
    ident = {"arch": cfg.MODEL.ARCH, "num_classes": cfg.MODEL.NUM_CLASSES,
             "moe": cfg.MODEL.MOE.to_dict()}
    return hashlib.sha256(json.dumps(ident, sort_keys=True, default=str).encode()).hexdigest()


def tree_spec(tree, prefix: str = "") -> dict:
    """Key path (``/``-joined) → ``{"shape", "dtype"}`` of every tensor
    leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_spec(v, path))
        elif torch.is_tensor(v):
            out[path] = {"shape": list(v.shape), "dtype": str(v.dtype)}
    return out


def is_dir_checkpoint(path: str) -> bool:
    """A sharded save's directory (its name has no ``.pth``; a quarantined
    one ``.corrupt[.N]`` after it)."""
    return ".pth" not in os.path.basename(path)


def manifest_path(path: str) -> str:
    if is_dir_checkpoint(path):
        return os.path.join(path, MANIFEST_NAME)
    return path + MANIFEST_SUFFIX


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(path: str, payload: dict, kind: str = "full",
                   epoch: int | None = None, world: int = 1) -> str:
    """The commit marker of the payload file at ``path``: call after the
    payload's rename, from the process that wrote it. Atomic: temporary
    file, fsync, ``os.replace``, then the directory fsync."""
    man = {
        "schema": MANIFEST_SCHEMA,
        "kind": kind,
        "epoch": None if epoch is None else int(epoch),
        "fingerprint": config_fingerprint(),
        "topology": {"processes": int(world)},
        "tree": tree_spec(payload),
        "files": {os.path.basename(path): {"size": os.path.getsize(path),
                                           "sha256": sha256_file(path)}},
    }
    return _commit_json(manifest_path(path), man)


def _commit_json(dest: str, man: dict) -> str:
    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dest)
    _fsync_dir(os.path.dirname(dest))
    return dest


def write_dir_manifest(path: str, tree: dict, kind: str = "full", epoch: int | None = None,
                       world: int = 1, sharded: dict | None = None) -> str:
    """The commit marker of the sharded save directory ``path``: every file
    under it with its size and sha256, the tree spec ``tree`` (computed
    on-path: the committer holds no full payload) and the ``sharded``
    record. Call once every process's files are durable (the primary,
    behind the cross-host barrier)."""
    files = {}
    for dirpath, _, names in os.walk(path):
        for name in sorted(names):
            if name in (MANIFEST_NAME, MANIFEST_NAME + ".tmp"):
                continue
            full = os.path.join(dirpath, name)
            files[os.path.relpath(full, path)] = {"size": os.path.getsize(full),
                                                  "sha256": sha256_file(full)}
    man = {"schema": MANIFEST_SCHEMA, "kind": kind,
           "epoch": None if epoch is None else int(epoch),
           "fingerprint": config_fingerprint(), "topology": {"processes": int(world)},
           "tree": tree, "files": files}
    if sharded is not None:
        man["sharded"] = sharded
    return _commit_json(manifest_path(path), man)


def read_manifest(path: str) -> dict | None:
    """The committed manifest of ``path``, or None."""
    try:
        with open(manifest_path(path)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_checkpoint(path: str) -> tuple[bool, str]:
    """``(ok, reason)``: the payload file exists and its size and sha256
    are the ones its manifest committed (a sharded directory: every file
    its manifest names)."""
    if is_dir_checkpoint(path):
        return _verify_dir(path)
    if not os.path.isfile(path):
        return False, "not a file"
    man = read_manifest(path)
    if man is None:
        return False, ("no committed manifest (save interrupted before commit, or a "
                       "pre-manifest checkpoint)")
    meta = man.get("files", {}).get(os.path.basename(path))
    if meta is None:
        return False, "manifest names another payload file"
    size = os.path.getsize(path)
    if size != meta["size"]:
        return False, (f"payload file truncated/resized: {os.path.basename(path)} "
                       f"({size} bytes, manifest says {meta['size']})")
    if sha256_file(path) != meta["sha256"]:
        return False, f"payload file digest mismatch: {os.path.basename(path)}"
    return True, "ok"


def _verify_dir(path: str) -> tuple[bool, str]:
    if not os.path.isdir(path):
        return False, "not a directory"
    man = read_manifest(path)
    if man is None:
        return False, ("no committed manifest (save interrupted before commit, or a "
                       "pre-manifest checkpoint)")
    for rel, meta in man.get("files", {}).items():
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            return False, f"payload file missing: {rel}"
        size = os.path.getsize(full)
        if size != meta["size"]:
            return False, (f"payload file truncated/resized: {rel} ({size} bytes, manifest "
                           f"says {meta['size']})")
        if sha256_file(full) != meta["sha256"]:
            return False, f"payload file digest mismatch: {rel}"
    return True, "ok"
