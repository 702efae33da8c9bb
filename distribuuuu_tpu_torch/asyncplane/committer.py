"""Background checkpoint committer (counterpart of
distribuuuu_tpu/asyncplane/committer.py).

Under ``CHECKPOINT.ASYNC`` a save splits in two. The trainer blocks for
the device-to-host snapshot (``utils/checkpoint._cpu``, a copy the next
steps cannot touch); the durable half, ``torch.save`` to a temporary file,
its fsync, the rename, then the manifest last, runs here on one daemon
thread. The invariants of the synchronous protocol hold:

* the manifest commits strictly after the payload is on disk, so a
  process killed inside the commit leaves a manifest-less file that
  ``find_last_valid_checkpoint`` quarantines and walks back over;
* one commit is in flight: :func:`submit_commit` joins the previous one
  first, so snapshot memory is bounded and commit order is save order;
* a failed commit is not silent: it is re-raised as
  :class:`AsyncCommitError` at the next join (the next save, a resume or
  rollback, a preemption save, the end of ``train_model``, ``atexit``).

With several processes a background save commits through the JAX
package's file-based cross-host commit barrier (:func:`multihost_commit`):
the primary opens it, every process makes its share of the payload
durable and arrives, and the primary writes the manifest strictly last,
once all have arrived; the others wait for that manifest, so a save is
committed on every process or on none. A full-tensor save is the
primary's one file (its peers only arrive); a ZeRO run's state, split
across the processes, is written by each process as its own shard file
and layout in the JAX package's format (:func:`write_host_shards`,
``shards_host<r>.npz`` + ``SHARDS_host<r>.json``), which
:func:`read_sharded_checkpoint` and the JAX package's reader put back
together. Every wait is bounded by ``ASYNC.BARRIER_TIMEOUT_S``. Each
background save lands one ``ckpt.async`` record (:func:`emit_commit_record`),
each process one ``ckpt.barrier`` record and, in a sharded save, one
``ckpt.shard`` record.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
import time

import numpy as np

from distribuuuu_tpu_torch.telemetry import spans as telemetry_spans
from distribuuuu_tpu_torch.utils.logger import get_logger


class AsyncCommitError(RuntimeError):
    """A background checkpoint commit failed; raised at the next join."""


_state: dict = {
    "thread": None,   # the in-flight commit, or None
    "label": None,    # its checkpoint's file name
    "error": None,    # (label, exception) of a failed commit
    "commits": 0,     # commits completed in this process
    "windows": [],    # (label, perf_counter start, end) of each commit
    "atexit": False,
    "barrier_s": None,  # this process's wait at the last cross-host barrier
    "shard": None,      # {"bytes", "write_s"} of its last shard write
}
_lock = threading.Lock()


def pending_commits() -> bool:
    """True while a commit is in flight."""
    t = _state["thread"]
    return t is not None and t.is_alive()


def commit_windows() -> list:
    """``(label, t0, t1)`` (``time.perf_counter``) of every commit run in
    this process: the steps that overlap them are measured against the
    others."""
    return list(_state["windows"])


def submit_commit(label: str, fn) -> None:
    """Run ``fn`` (payload write, then manifest) on the committer thread,
    after joining the previous commit."""
    join_commits()
    with _lock:
        if not _state["atexit"]:
            atexit.register(_drain_at_exit)
            _state["atexit"] = True
        t = threading.Thread(target=_run, args=(label, fn), daemon=True,
                             name="dtpu-ckpt-committer")
        _state["thread"], _state["label"] = t, label
    t.start()


def _run(label: str, fn) -> None:
    t0 = time.perf_counter()
    try:
        fn()
        _state["commits"] += 1
    except BaseException as e:  # surfaces at the next join, never silent
        _state["error"] = (label, e)
        get_logger().error("async checkpoint commit FAILED for %s after %.2fs: %s",
                           label, time.perf_counter() - t0, e)
    finally:
        _state["windows"].append((label, t0, time.perf_counter()))


def join_commits(reason: str = "") -> None:
    """Block until the in-flight commit (if any) is durable, then re-raise
    a commit failure. ``reason`` names the join in the log line."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.resilience import supervisor

    with _lock:
        t, label = _state["thread"], _state["label"]
        _state["thread"] = _state["label"] = None
    if t is not None:
        waited = t.is_alive()
        with supervisor.watch_blocking(f"async checkpoint commit ({label})",
                                       cfg.TRAIN.STALL_TIMEOUT):
            t.join()
        if reason:
            get_logger().info("async checkpoint committer drained (%s): %s %s; %d "
                              "commit(s) completed in this process", reason, label,
                              "joined the in-flight commit" if waited else "already durable",
                              _state["commits"])
    err = _state["error"]
    if err is not None:
        _state["error"] = None
        elabel, e = err
        raise AsyncCommitError(
            f"async checkpoint commit failed for {elabel}: {type(e).__name__}: {e}. "
            "The checkpoint has no committed manifest: auto-resume quarantines it and "
            "walks back to the previous intact save."
        ) from e


def emit_commit_record(ckpt: str, snapshot_s: float, commit_s: float, ok: bool = True) -> None:
    """One ``kind="ckpt.async"`` record per background save: the
    trainer's blocking snapshot against the committer's off-path write."""
    telemetry_spans.emit_event("ckpt.async", ckpt=ckpt, snapshot_s=round(float(snapshot_s), 6),
                               commit_s=round(float(commit_s), 6), ok=bool(ok))


def _drain_at_exit() -> None:
    try:
        join_commits(reason="exit")
    except AsyncCommitError:
        pass  # logged by _run; the next start's walk-back handles the file


# ---------------------------------------------------------------- shard files

SHARD_FORMAT = "dtpu_sharded_v1"


class ShardLayoutError(RuntimeError):
    """A sharded checkpoint cannot be restored as recorded: shard files are
    missing or their layouts disagree."""


def _layout_name(rank: int) -> str:
    return f"SHARDS_host{rank}.json"


def shards_name(rank: int) -> str:
    return f"shards_host{rank}.npz"


class Blocks:
    """A leaf of ``shape`` and ``dtype`` (a layout dtype name: ``float32``,
    ``bfloat16``, ...) of which this process holds ``blocks``:
    ``(index, array)`` pairs, ``index`` one ``[start, stop]`` a dim, each
    block owned by exactly one process worldwide."""

    def __init__(self, shape, dtype: str, blocks):
        self.shape, self.dtype, self.blocks = tuple(shape), dtype, list(blocks)


def _flat(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*prefix, str(k)))
        else:
            yield [*prefix, str(k)], v


def tree_is_cross_host_sharded(tree: dict) -> bool:
    """Whether some :class:`Blocks` leaf's blocks here do not cover it
    (a leaf split across processes). Every process answers the same."""
    for _, leaf in _flat(tree):
        if isinstance(leaf, Blocks):
            total = int(np.prod(leaf.shape)) if leaf.shape else 1
            if sum(a.size for _, a in leaf.blocks) < total:
                return True
    return False


def snapshot_host_shards(tree: dict, rank: int):
    """This process's blocks of ``tree`` (nested dicts whose leaves are
    :class:`Blocks`, held by their owners, or host values, identical on
    every process and owned by rank 0) as ``(owned, layout)``: the raw
    arrays keyed for the npz, and the layout whose ``leaves`` spec is the
    same on every process (each shard file describes itself)."""
    leaves_spec, owned, shards = [], {}, []
    for ln, (path, leaf) in enumerate(_flat(tree)):
        if isinstance(leaf, Blocks):
            leaves_spec.append({"path": path, "shape": list(leaf.shape), "dtype": leaf.dtype})
            for si, (index, arr) in enumerate(leaf.blocks):
                key = f"{ln:05d}.{si}"
                owned[key] = arr
                shards.append({"leaf": ln, "key": key, "index": [list(i) for i in index],
                               "shape": list(arr.shape), "dtype": leaf.dtype})
            continue
        host = np.asarray(leaf)
        leaves_spec.append({"path": path, "shape": list(host.shape),
                            "dtype": host.dtype.name})
        if rank == 0:
            key = f"{ln:05d}.0"
            owned[key] = host
            shards.append({"leaf": ln, "key": key, "index": [[0, int(d)] for d in host.shape],
                           "shape": list(host.shape), "dtype": host.dtype.name})
    return owned, {"format": SHARD_FORMAT, "leaves": leaves_spec, "shards": shards}


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def write_host_shards(path: str, rank: int, world: int, owned: dict, layout: dict) -> int:
    """Durably write this process's shard payload and its layout under the
    checkpoint directory ``path`` (raw little-endian bytes in the npz, so
    bfloat16 round-trips through the layout's dtype name). Returns the
    payload bytes."""
    os.makedirs(path, exist_ok=True)
    nbytes, packed = 0, {}
    for key, arr in owned.items():
        arr = np.ascontiguousarray(arr)
        nbytes += arr.nbytes
        packed[key] = np.frombuffer(arr.tobytes(), dtype=np.uint8)
    with open(os.path.join(path, shards_name(rank)), "wb") as f:
        np.savez(f, **packed)
        f.flush()
        os.fsync(f.fileno())
    lpath = os.path.join(path, _layout_name(rank))
    with open(lpath + ".tmp", "w") as f:
        json.dump(dict(layout, host=int(rank), hosts=int(world)), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(lpath + ".tmp", lpath)
    return nbytes


def sharded_layout_present(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _layout_name(0)))


def read_sharded_checkpoint(path: str) -> dict:
    """The full tree of a sharded checkpoint (nested dicts of numpy arrays;
    bfloat16 leaves as float32, exactly), put together from every recorded
    shard file; a missing file or a leaf its shards do not cover raises
    :class:`ShardLayoutError` naming the recorded sharding."""
    from distribuuuu_tpu_torch.utils import orbax

    try:
        return orbax.read_sharded(path)
    except orbax.OrbaxFormatError as e:
        raise ShardLayoutError(str(e)) from None


def emit_shard_record(ckpt: str, host: int, hosts: int, shards: int, nbytes: int,
                      write_s: float) -> None:
    """One ``ckpt.shard`` record a process a sharded save: its own write."""
    _state["shard"] = {"bytes": int(nbytes), "write_s": float(write_s)}
    telemetry_spans.emit_event("ckpt.shard", ckpt=ckpt, host=int(host), hosts=int(hosts),
                               shards=int(shards), bytes=int(nbytes),
                               write_s=round(float(write_s), 6))


# ---------------------------------------------------------------- the barrier

_BARRIER_OPEN = "OPEN"


def barrier_dir(path: str) -> str:
    """The barrier's rendezvous directory of one checkpoint: a hidden
    sibling on the storage the manifests live on (never inside a sharded
    save's directory, whose files the manifest digests)."""
    return os.path.join(os.path.dirname(path), "." + os.path.basename(path) + ".barrier")


def _fsync_tree(root: str) -> None:
    """fsync ``root`` (a file) or every file and directory under it: the
    durability a process attests by arriving. A file that vanished is a
    peer's rename in flight; that peer fsyncs its own before arriving."""
    if os.path.isfile(root):
        _fsync_file(root)
        root = os.path.dirname(root)
        fd = os.open(root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        return
    for dirpath, _, names in os.walk(root):
        for name in names:
            try:
                _fsync_file(os.path.join(dirpath, name))
            except FileNotFoundError:
                continue
        fd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def open_barrier(path: str) -> str:
    """The primary (re)creates the barrier directory with a fresh OPEN
    sentinel; clearing it first means a stale barrier of a killed attempt
    cannot satisfy this save."""
    bdir = barrier_dir(path)
    shutil.rmtree(bdir, ignore_errors=True)
    os.makedirs(bdir, exist_ok=True)
    with open(os.path.join(bdir, _BARRIER_OPEN), "w") as f:
        f.write(str(time.time()))
        f.flush()
        os.fsync(f.fileno())
    return bdir


def _arrive_marker(path: str, rank: int) -> str:
    return os.path.join(barrier_dir(path), f"host{rank}.arrived")


def arrive_barrier(path: str, rank: int) -> None:
    """This process's share of the payload is durable."""
    with open(_arrive_marker(path, rank), "w") as f:
        f.write(str(time.time()))
        f.flush()
        os.fsync(f.fileno())


def _wait_for(predicate, label: str, timeout: float, keepalive=None) -> float:
    """Poll ``predicate`` under the stall watchdog; the seconds waited, or
    ``TimeoutError`` past ``timeout`` (``ASYNC.BARRIER_TIMEOUT_S``)."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.resilience import supervisor

    t0 = time.monotonic()
    with supervisor.watch_blocking(label, cfg.TRAIN.STALL_TIMEOUT):
        while not predicate():
            if keepalive is not None:
                keepalive()
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"{label}: no progress after {timeout:.0f}s (ASYNC.BARRIER_TIMEOUT_S): a "
                    "peer process died or the shared storage is unreachable; the save has "
                    "no committed manifest and auto-resume will walk back")
            time.sleep(0.02)
    return time.monotonic() - t0


def emit_barrier_record(ckpt: str, host: int, hosts: int, wait_s: float) -> None:
    """One ``ckpt.barrier`` record a process a many-process background save."""
    telemetry_spans.emit_event("ckpt.barrier", ckpt=ckpt, host=int(host), hosts=int(hosts),
                               wait_s=round(float(wait_s), 6))


def multihost_commit(path: str, epoch: int, write_manifest, manifest_file: str,
                     rank: int, world: int, write_payload=None, write_local=None,
                     post_commit=None, sharded: bool = False) -> float:
    """One process's share of a cross-host background commit (on its
    committer thread), the JAX package's protocol. The primary opens the
    barrier, writes its payload (``write_payload``), fsyncs it, arrives,
    waits for every process's arrival, then writes the manifest
    (``write_manifest``; ``manifest_file`` is where it lands) and runs
    ``post_commit``. A peer waits for the barrier to open, writes its own
    share (``write_local``: its shard file and layout), arrives, and waits
    for the manifest, re-asserting its arrival against a concurrent reset.
    The manifest is strictly last, behind every process's durability.
    ``sharded`` arms ``FAULTS.KILL_AT_SHARD_BARRIER`` beside
    ``FAULTS.KILL_AT_COMMIT_BARRIER``. Returns the seconds waited."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.utils import faults

    timeout = float(cfg.ASYNC.BARRIER_TIMEOUT_S)
    name = os.path.basename(path)
    if rank == 0:
        open_barrier(path)
        if write_payload is not None:
            write_payload()
        if os.path.exists(path):
            _fsync_tree(path)  # arrival attests durability
        arrive_barrier(path, 0)
        wait_s = _wait_for(lambda: all(os.path.isfile(_arrive_marker(path, r))
                                       for r in range(world)),
                           f"cross-host commit barrier ({name})", timeout)
        faults.maybe_kill_at_commit_barrier(path, epoch)
        if sharded:
            faults.maybe_kill_at_shard_barrier(path, epoch)
        write_manifest()
        if post_commit is not None:
            post_commit()
        shutil.rmtree(barrier_dir(path), ignore_errors=True)
    else:
        bdir = barrier_dir(path)
        wait_open = _wait_for(lambda: os.path.isfile(os.path.join(bdir, _BARRIER_OPEN)),
                              f"cross-host barrier open ({name})", timeout)
        if write_local is not None:
            write_local()
        arrive_barrier(path, rank)

        def reassert():
            try:
                if not os.path.isfile(_arrive_marker(path, rank)):
                    arrive_barrier(path, rank)
            except OSError:
                pass  # the barrier is mid-reset; the next poll re-asserts

        wait_s = wait_open + _wait_for(lambda: os.path.isfile(manifest_file),
                                       f"cross-host manifest wait ({name})", timeout,
                                       keepalive=reassert)
    emit_barrier_record(name, rank, world, wait_s)
    _state["barrier_s"] = wait_s
    return wait_s
