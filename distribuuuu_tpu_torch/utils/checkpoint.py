"""Checkpoints and auto-resume (counterpart of distribuuuu_tpu/utils/checkpoint.py).

One ``torch.save`` payload per save under ``{OUT_DIR}/checkpoints``, by the
JAX package's names: ``ckpt_ep_NNN.pth`` after epoch NNN (the parameters
and BN buffers, the optimizer state, the step, the epoch and ``best_acc1``),
a weights-only ``best.pth`` on a new best, and ``preempt_ep_NNN.pth``
written mid-epoch on preemption. ``preempt_ep_e`` holds newer progress than
``ckpt_ep_{e-1}`` and is superseded by ``ckpt_ep_e``; auto-resume loads the
newest. A save is written to a temporary file and renamed, so a crash
leaves no half-written checkpoint under a final name; a load that fails
raises :class:`CheckpointError` naming the path. With several processes
only the primary writes, every process waits at a barrier after each
save, and every process loads; the payload is the same as with one
process (the model's ``state_dict`` keys unchanged), so a checkpoint of
either resumes the other.

The orbax format, background commits (``CHECKPOINT.ASYNC``), manifests
and quarantine are not ported.
"""

from __future__ import annotations

import os
import re

import torch

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist

_NAME_PREFIX = "ckpt_ep_"
_PREEMPT_PREFIX = "preempt_ep_"
_BEST_NAME = "best"
_EXT = ".pth"


class CheckpointError(RuntimeError):
    """A checkpoint could not be read."""


def get_checkpoint_dir() -> str:
    return os.path.abspath(os.path.join(cfg.OUT_DIR, "checkpoints"))


def get_checkpoint(epoch: int) -> str:
    return os.path.join(get_checkpoint_dir(), f"{_NAME_PREFIX}{epoch:03d}{_EXT}")


def get_preempt_checkpoint(epoch: int) -> str:
    return os.path.join(get_checkpoint_dir(), f"{_PREEMPT_PREFIX}{epoch:03d}{_EXT}")


def get_best_checkpoint() -> str:
    return os.path.join(get_checkpoint_dir(), _BEST_NAME + _EXT)


def _scan(prefix: str) -> dict[int, str]:
    d = get_checkpoint_dir()
    if not os.path.isdir(d):
        return {}
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(_EXT))
    return {int(m.group(1)): os.path.join(d, f)
            for f in os.listdir(d) if (m := pat.fullmatch(f))}


def get_last_checkpoint() -> str:
    """The newest checkpoint: ``preempt_ep_e`` ranks between
    ``ckpt_ep_{e-1}`` and ``ckpt_ep_e``."""
    ranked = [(2 * e + 2, p) for e, p in _scan(_NAME_PREFIX).items()]
    ranked += [(2 * e + 1, p) for e, p in _scan(_PREEMPT_PREFIX).items()]
    if not ranked:
        raise FileNotFoundError(f"No checkpoints in {get_checkpoint_dir()}")
    return max(ranked)[1]


def has_checkpoint() -> bool:
    return bool(_scan(_NAME_PREFIX) or _scan(_PREEMPT_PREFIX))


def _write(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def prune_preempts(upto: int) -> None:
    """Delete preempt checkpoints numbered ``<= upto`` (superseded), on the
    primary."""
    if not dist.is_primary():
        return
    for e, p in _scan(_PREEMPT_PREFIX).items():
        if e <= upto:
            os.remove(p)


def save_checkpoint(state: dict, epoch: int, best_acc1: float, is_best: bool) -> str:
    """Save the full state after ``epoch`` (``state``: ``model``, ``opt``,
    ``step``); side-write the weights-only ``best`` on a new best. The
    primary writes; every process returns the path after the barrier."""
    path = get_checkpoint(epoch)
    if dist.is_primary():
        payload = {**_cpu(state), "epoch": epoch, "best_acc1": float(best_acc1)}
        _write(path, payload)
        if is_best:
            _write(get_best_checkpoint(), {"model": payload["model"], "epoch": epoch})
        prune_preempts(epoch)
    dist.barrier()
    return path


def save_preempt_checkpoint(state: dict, epoch: int, best_acc1: float,
                            pending_eval: int | None = None) -> str:
    """Mid-epoch save on preemption. ``epoch`` is the interrupted one; the
    stored cursor is ``epoch - 1`` so the resume re-runs that epoch from
    this newer state. ``pending_eval`` marks a finished epoch whose
    validation was preempted: the resume validates it first. The primary
    writes, behind a barrier."""
    path = get_preempt_checkpoint(epoch)
    if dist.is_primary():
        payload = {**_cpu(state), "epoch": epoch - 1, "best_acc1": float(best_acc1)}
        if pending_eval is not None:
            payload["pending_eval"] = int(pending_eval)
        _write(path, payload)
    dist.barrier()
    return path


def load_checkpoint(path: str) -> dict:
    """The payload at ``path`` (tensors on the CPU); raises
    :class:`CheckpointError` naming the path when it cannot be read."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # torch.load raises many concrete types
        raise CheckpointError(
            f"failed to load checkpoint {path} ({type(e).__name__}: {e}); move it "
            "aside to resume from the previous one, or start a fresh OUT_DIR"
        ) from e
