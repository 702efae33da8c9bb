"""Deterministic fault injection (counterpart of distribuuuu_tpu/utils/faults.py).

Each failure the resilience layer claims to survive is a config-driven
event here, so the tests drive the real recovery code:

  NaN at step k          ``FAULTS.NAN_STEP``: ``trainer.train_step``
                         multiplies every micro-batch's loss by NaN at
                         optimizer step k, so loss and gradients go
                         non-finite exactly there;
  decode error           ``FAULTS.DECODE_ERROR_IDX/MODE``: sample i's
                         decode raises ("once": the loader's first retry
                         succeeds; "always": it is skipped and logged);
  killed rank            ``FAULTS.KILL_RANK/KILL_EPOCH/KILL_AT_BATCH``:
                         SIGKILL at a batch boundary;
  stalled step           ``FAULTS.STALL_EPOCH/STALL_AT_BATCH/STALL_S``:
                         sleep so the heartbeat watchdog flags;
  preemption             ``FAULTS.PREEMPT_EPOCH/PREEMPT_AT_BATCH``: SIGTERM
                         to this process through the installed handler;
  sustained slowdown     ``FAULTS.SLOWDOWN_EPOCH/SLOWDOWN_MS``: sleep at
                         every batch boundary of one epoch;
  killed mid-async-save  ``FAULTS.KILL_MID_ASYNC_SAVE``: SIGKILL between
                         ``ckpt_ep_e.pth``'s rename and its manifest;
  corrupt checkpoint     ``FAULTS.CORRUPT_EPOCH/MODE``: after
                         ``ckpt_ep_e.pth`` commits, "truncate" halves the
                         file, "partial" deletes its manifest.
  truncated shard        ``FAULTS.TRUNCATE_SHARD``: shard file k of a
                         split cut to 60 % of its size (footer and tail
                         records lost) before the reader opens it;
  recompile storm        ``FAULTS.RECOMPILE_EPOCH/RECOMPILE_AT_BATCH/
                         RECOMPILE_N``: N real CUDA graph captures of
                         trivial bodies at distinct shapes, once, at that
                         batch (the card only: the CPU has no graph).

Every hook is one attribute read unless ``FAULTS.ENABLED``. The knobs whose
mechanism the port does not have are refused by :func:`validate_cfg`,
each with its ROADMAP item.
"""

from __future__ import annotations

import os
import signal
import time

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist

# knob -> (what it exercises, the ROADMAP item that brings its mechanism)
REFUSED = {
    "KILL_AT_SHARD_BARRIER": ("a kill inside a sharded checkpoint commit",
                              "Parallel layouts beyond DP"),
    "DROP_SHARD_FILE": ("a lost shard file of a sharded checkpoint",
                        "Parallel layouts beyond DP"),
    "WEDGE_DISPATCH": ("a wedged dispatch sequencer",
                       "Async, resilience, live plane, shards and analysis"),
    "WEDGE_RING": ("a wedged cross-host dispatch ring",
                   "Async, resilience, live plane, shards and analysis"),
    "KILL_AT_COMMIT_BARRIER": ("a kill at the cross-host commit barrier",
                               "Async, resilience, live plane, shards and analysis"),
}


class InjectedFault(RuntimeError):
    """An injected failure, distinguishable from organic errors in logs."""


_state: dict = {"decode_raised": set(), "preempted": False, "truncated_shards": set(),
                "recompiled": False}


def reset() -> None:
    """Clear the one-shot bookkeeping (tests)."""
    _state["decode_raised"] = set()
    _state["preempted"] = False
    _state["truncated_shards"] = set()
    _state["recompiled"] = False


def enabled() -> bool:
    return bool(cfg.FAULTS.ENABLED)


def validate_cfg(platform: str = "auto") -> None:
    """Refuse, at start-up, an armed knob the port cannot inject, and the
    recompile storm on ``DEVICE.PLATFORM cpu`` (no graph to capture there);
    check the modes. No-op unless ``FAULTS.ENABLED``."""
    if not enabled():
        return
    for knob, (what, item) in REFUSED.items():
        if int(cfg.FAULTS[knob]) >= 0:
            raise not_ported(f"FAULTS.{knob} ({what})", item)
    if int(cfg.FAULTS.RECOMPILE_AT_BATCH) >= 0 and platform == "cpu":
        raise ValueError("FAULTS.RECOMPILE_AT_BATCH needs the card: its storm is CUDA graph "
                         "captures, and the CPU has no graph")
    for knob, modes in (("DECODE_ERROR_MODE", ("once", "always")),
                        ("CORRUPT_MODE", ("truncate", "partial"))):
        if cfg.FAULTS[knob] not in modes:
            raise ValueError(f"FAULTS.{knob}={cfg.FAULTS[knob]!r}: one of {modes}")


def nan_injection_step() -> int | None:
    """The global step whose loss is multiplied by NaN, or None."""
    if enabled() and cfg.FAULTS.NAN_STEP >= 0:
        return int(cfg.FAULTS.NAN_STEP)
    return None


def maybe_decode_error(idx: int) -> None:
    """Raise for the configured sample index ("once": only its first
    touch; "always": every time)."""
    if not enabled() or cfg.FAULTS.DECODE_ERROR_IDX < 0:
        return
    if int(idx) != int(cfg.FAULTS.DECODE_ERROR_IDX):
        return
    if cfg.FAULTS.DECODE_ERROR_MODE == "once":
        if idx in _state["decode_raised"]:
            return
        _state["decode_raised"].add(idx)
    raise InjectedFault(f"injected decode error on sample {idx}")


def maybe_kill(epoch: int, batch: int) -> None:
    """SIGKILL this process at the configured (rank, epoch, batch)."""
    if not enabled() or cfg.FAULTS.KILL_RANK < 0:
        return
    if (dist.get_rank() == int(cfg.FAULTS.KILL_RANK) and epoch == int(cfg.FAULTS.KILL_EPOCH)
            and batch == int(cfg.FAULTS.KILL_AT_BATCH)):
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_preempt(epoch: int, batch: int) -> None:
    """SIGTERM to this process at the configured (epoch, batch), once."""
    if not enabled() or cfg.FAULTS.PREEMPT_AT_BATCH < 0 or _state["preempted"]:
        return
    if epoch == int(cfg.FAULTS.PREEMPT_EPOCH) and batch == int(cfg.FAULTS.PREEMPT_AT_BATCH):
        _state["preempted"] = True
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_truncate_shard(split_dir: str) -> None:
    """Truncate shard file ``FAULTS.TRUNCATE_SHARD`` of the split to 60 %
    of its manifest size, destroying its index footer and tail records,
    before the reader opens it: the reader's forward-scan recovery and the
    loader's ``DATA.SKIP_CORRUPT`` substitution of the lost records run.
    Once per (process, split); a shard already cut is left alone."""
    if not enabled() or cfg.FAULTS.TRUNCATE_SHARD < 0:
        return
    if split_dir in _state["truncated_shards"]:
        return
    _state["truncated_shards"].add(split_dir)
    import json

    from distribuuuu_tpu_torch.data.shards.format import MANIFEST_NAME

    try:
        with open(os.path.join(split_dir, MANIFEST_NAME)) as f:
            meta = json.load(f)["shards"][int(cfg.FAULTS.TRUNCATE_SHARD)]
    except (OSError, ValueError, IndexError, KeyError):
        return  # nothing to damage: the reader reports the split itself
    path = os.path.join(split_dir, meta["file"])
    if os.path.isfile(path) and os.path.getsize(path) == meta["size"]:
        with open(path, "r+b") as f:
            f.truncate(max(1, int(meta["size"]) * 6 // 10))


def maybe_recompile(epoch: int, batch: int, device) -> int:
    """At ``(RECOMPILE_EPOCH, RECOMPILE_AT_BATCH)``, ``RECOMPILE_N`` real
    graph captures of trivial bodies at distinct shapes
    (``graphs.capture_trivial``): the mid-run recompile storm a shape leak
    causes, while training math is untouched (nothing here feeds the
    step). One-shot per process. Returns the captures made."""
    if not enabled() or cfg.FAULTS.RECOMPILE_AT_BATCH < 0 or _state["recompiled"]:
        return 0
    if epoch != int(cfg.FAULTS.RECOMPILE_EPOCH) or batch != int(cfg.FAULTS.RECOMPILE_AT_BATCH):
        return 0
    _state["recompiled"] = True
    from distribuuuu_tpu_torch import graphs

    return graphs.capture_trivial(max(1, int(cfg.FAULTS.RECOMPILE_N)), device)


def maybe_slowdown(epoch: int, batch: int) -> None:
    """Sleep ``SLOWDOWN_MS`` at every batch boundary of the epoch."""
    if not enabled() or cfg.FAULTS.SLOWDOWN_MS <= 0:
        return
    if epoch == int(cfg.FAULTS.SLOWDOWN_EPOCH):
        time.sleep(float(cfg.FAULTS.SLOWDOWN_MS) / 1e3)


def maybe_stall(epoch: int, batch: int) -> None:
    """Sleep ``STALL_S`` at the configured batch boundary."""
    if not enabled() or cfg.FAULTS.STALL_AT_BATCH < 0:
        return
    if (epoch == int(cfg.FAULTS.STALL_EPOCH) and batch == int(cfg.FAULTS.STALL_AT_BATCH)
            and cfg.FAULTS.STALL_S > 0):
        time.sleep(float(cfg.FAULTS.STALL_S))


def maybe_kill_mid_async_save(path: str, epoch: int) -> None:
    """SIGKILL between an epoch checkpoint's rename and its manifest
    (epoch checkpoints only)."""
    if not enabled() or cfg.FAULTS.KILL_MID_ASYNC_SAVE < 0:
        return
    if os.path.basename(path).startswith("ckpt_ep_") and \
            epoch == int(cfg.FAULTS.KILL_MID_ASYNC_SAVE):
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_corrupt_checkpoint(path: str, epoch: int) -> None:
    """Damage a just-committed epoch checkpoint: "truncate" halves the
    payload file, "partial" deletes its manifest. The primary only."""
    if not enabled() or cfg.FAULTS.CORRUPT_EPOCH < 0:
        return
    if epoch != int(cfg.FAULTS.CORRUPT_EPOCH) or not dist.is_primary():
        return
    from distribuuuu_tpu_torch.resilience.manifest import manifest_path

    if cfg.FAULTS.CORRUPT_MODE == "partial":
        if os.path.isfile(manifest_path(path)):
            os.unlink(manifest_path(path))
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
