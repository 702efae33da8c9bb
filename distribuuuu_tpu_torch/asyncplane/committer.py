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

With several processes only the primary writes, so the JAX package's
cross-host commit barrier and sharded saves have nothing to do here; a
rank that must read a checkpoint waits for the primary's join through
``find_last_valid_checkpoint``'s broadcast.
"""

from __future__ import annotations

import atexit
import threading
import time

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


def _drain_at_exit() -> None:
    try:
        join_commits(reason="exit")
    except AsyncCommitError:
        pass  # logged by _run; the next start's walk-back handles the file
