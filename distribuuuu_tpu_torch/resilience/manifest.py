"""Checkpoint manifests (counterpart of distribuuuu_tpu/resilience/manifest.py).

The port keeps one ``torch.save`` file a checkpoint (``ckpt_ep_NNN.pth``,
``preempt_ep_NNN.pth``, ``best.pth``). Its commit marker is a JSON sidecar
beside it, ``<name>.pth.manifest.json``, written through a temporary file
and ``os.replace`` strictly after the payload's own rename. It records the
payload's size and sha256, the epoch, the kind (``full`` or ``weights``),
the arch fingerprint and the tree spec (key path → shape and dtype).

No manifest ⇒ the save never completed ⇒ the checkpoint is invalid. A
manifest whose size or digest disagrees with the file ⇒ corrupt.
``utils/checkpoint.find_last_valid_checkpoint`` walks back over both,
quarantining them. Elastic re-sharding (``classify_topology``) belongs to
ZeRO (ROADMAP "Parallel layouts beyond DP"): the port's payload is
replicated, so a resume at another world size loads it as it is.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

from distribuuuu_tpu_torch.config import cfg

MANIFEST_SUFFIX = ".manifest.json"
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


def manifest_path(path: str) -> str:
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
    dest = manifest_path(path)
    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dest)
    _fsync_dir(os.path.dirname(dest))
    return dest


def read_manifest(path: str) -> dict | None:
    """The committed manifest of ``path``, or None."""
    try:
        with open(manifest_path(path)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_checkpoint(path: str) -> tuple[bool, str]:
    """``(ok, reason)``: the payload file exists and its size and sha256
    are the ones its manifest committed."""
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
