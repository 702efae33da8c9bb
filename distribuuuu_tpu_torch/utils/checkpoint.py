"""Checkpoints and auto-resume (counterpart of distribuuuu_tpu/utils/checkpoint.py).

One ``torch.save`` payload per save under ``{OUT_DIR}/checkpoints``, by the
JAX package's names: ``ckpt_ep_NNN.pth`` after epoch NNN (the parameters
and BN buffers, the optimizer state, the step, the epoch and ``best_acc1``),
a weights-only ``best.pth`` on a new best, and ``preempt_ep_NNN.pth``
written mid-epoch on preemption. ``preempt_ep_e`` holds newer progress than
``ckpt_ep_{e-1}`` and is superseded by ``ckpt_ep_e``.

Crash consistency (``resilience/manifest.py``): a save writes the payload
to a temporary file and renames it, then commits its manifest sidecar
``<name>.pth.manifest.json`` strictly last. A file without its manifest
never committed. :func:`find_last_valid_checkpoint`, the resume's entry,
verifies candidates newest first, quarantines a corrupt or uncommitted
one to ``<name>.pth.corrupt[.N]`` and walks back to the newest intact
save; :class:`NoValidCheckpointError` when none survives.

``CHECKPOINT.ASYNC`` (``asyncplane/committer.py``): the trainer blocks for
the host snapshot only; the write, fsync, rename and manifest run on the
committer thread, in the same order. Preemption saves are synchronous and
join the committer first.

With several processes only the primary writes and quarantines; every
process loads. A synchronous save ends at a barrier; the walk-back runs
on the primary after it joins the committer, and every process takes the
path it broadcasts. The payload is the same as with one process (the
model's ``state_dict`` keys unchanged), so a checkpoint of either resumes
the other. The orbax format is not ported (ROADMAP "Orbax weights").
"""

from __future__ import annotations

import os
import re

import torch

from distribuuuu_tpu_torch.asyncplane import committer
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.resilience import manifest
from distribuuuu_tpu_torch.utils import faults
from distribuuuu_tpu_torch.utils.logger import get_logger

_NAME_PREFIX = "ckpt_ep_"
_PREEMPT_PREFIX = "preempt_ep_"
_BEST_NAME = "best"
_EXT = ".pth"


class CheckpointError(RuntimeError):
    """A checkpoint could not be read."""


class NoValidCheckpointError(CheckpointError, FileNotFoundError):
    """Checkpoints exist (or none do) but none verifies intact."""


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


def _ordered_candidates() -> list[str]:
    """Every resumable checkpoint, newest state first: ``preempt_ep_e``
    ranks between ``ckpt_ep_{e-1}`` and ``ckpt_ep_e``."""
    ranked = [(2 * e + 2, p) for e, p in _scan(_NAME_PREFIX).items()]
    ranked += [(2 * e + 1, p) for e, p in _scan(_PREEMPT_PREFIX).items()]
    return [p for _, p in sorted(ranked, reverse=True)]


def get_last_checkpoint() -> str:
    """The newest checkpoint by that ranking, unverified."""
    cands = _ordered_candidates()
    if not cands:
        raise FileNotFoundError(f"No checkpoints in {get_checkpoint_dir()}")
    return cands[0]


def has_checkpoint() -> bool:
    return bool(_scan(_NAME_PREFIX) or _scan(_PREEMPT_PREFIX))


def quarantine_checkpoint(path: str, reason: str) -> str | None:
    """Move a broken checkpoint (and its manifest, if any) aside as
    ``<name>.corrupt[.N]``, on the primary. Returns the new path."""
    logger = get_logger()
    if not dist.is_primary():
        logger.warning("checkpoint %s failed verification (%s): skipping (the primary "
                       "quarantines)", path, reason)
        return None
    dest, n = path + ".corrupt", 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.corrupt.{n}"
    try:
        os.replace(path, dest)
        if os.path.exists(manifest.manifest_path(path)):
            os.replace(manifest.manifest_path(path), manifest.manifest_path(dest))
    except OSError as e:
        logger.warning("could not quarantine %s (%s); skipping it", path, e)
        return None
    logger.warning("quarantined corrupt checkpoint %s -> %s (%s)", path, dest, reason)
    return dest


def _walk_back() -> tuple[str | None, str | None]:
    cands = _ordered_candidates()
    if not cands:
        return None, f"No checkpoints in {get_checkpoint_dir()}"
    for i, path in enumerate(cands):
        ok, reason = manifest.verify_checkpoint(path)
        if ok:
            if i:
                get_logger().warning("walked back over %d broken checkpoint(s) to %s", i, path)
            return path, None
        quarantine_checkpoint(path, reason)
    return None, (f"{len(cands)} checkpoint(s) under {get_checkpoint_dir()} but none "
                  "verified intact (all quarantined to *.corrupt); inspect the quarantined "
                  "files or restart training from scratch")


def find_last_valid_checkpoint() -> str:
    """The newest checkpoint that verifies, walking back over (and
    quarantining) corrupt or uncommitted ones; raises
    :class:`NoValidCheckpointError` when none survives. Joins the
    in-flight commit first; with several processes the primary walks and
    every process takes its answer."""
    committer.join_commits()
    path, err = _walk_back() if dist.is_primary() else (None, None)
    path, err = dist.broadcast_from_primary((path, err))
    if err is not None:
        raise NoValidCheckpointError(err)
    return path


def _cpu(tree):
    """A host copy of ``tree`` that later steps cannot touch (a CPU
    tensor is copied, not aliased)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _write(path: str, payload: dict, kind: str, epoch: int | None,
           durable: bool = False) -> str:
    """Payload to a temporary file, renamed into place, then the manifest
    strictly last. ``durable`` (the committer) fsyncs the payload before
    the rename, so the order holds through a power loss too."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    if durable:
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if kind == "full":
        # the crash window, injectable: the payload is in place, its
        # manifest is not (no-op unless FAULTS.*)
        faults.maybe_kill_mid_async_save(path, epoch if epoch is not None else -1)
    manifest.write_manifest(path, payload, kind=kind, epoch=epoch,
                            world=dist.get_world_size())
    return path


def _commit(label: str, fn) -> None:
    """``fn`` on the committer under ``CHECKPOINT.ASYNC``, else now."""
    if cfg.CHECKPOINT.ASYNC:
        committer.submit_commit(label, lambda: fn(True))
    else:
        fn(False)


def prune_preempts(upto: int) -> None:
    """Delete preempt checkpoints numbered ``<= upto`` (superseded), and
    their manifests, on the primary."""
    if not dist.is_primary():
        return
    for e, p in _scan(_PREEMPT_PREFIX).items():
        if e <= upto:
            os.remove(p)
            if os.path.exists(manifest.manifest_path(p)):
                os.remove(manifest.manifest_path(p))


def _best_payload(model_sd: dict, epoch: int) -> dict:
    return {"model": model_sd, "epoch": epoch}


def save_checkpoint(state: dict, epoch: int, best_acc1: float, is_best: bool) -> str:
    """Save the full state after ``epoch`` (``state``: ``model``, ``opt``,
    ``step``); side-write the weights-only ``best`` on a new best. After the
    commit: the best side-write, the preempt pruning and the corrupt-
    checkpoint fault hook. The primary writes (on the committer under
    ``CHECKPOINT.ASYNC``); a synchronous save ends at a barrier."""
    path = get_checkpoint(epoch)
    if dist.is_primary():
        payload = {**_cpu(state), "epoch": epoch, "best_acc1": float(best_acc1)}

        def commit(durable):
            _write(path, payload, "full", epoch, durable)
            if is_best:
                _write(get_best_checkpoint(), _best_payload(payload["model"], epoch),
                       "weights", epoch, durable)
            prune_preempts(epoch)
            faults.maybe_corrupt_checkpoint(path, epoch)

        _commit(os.path.basename(path), commit)
    if not cfg.CHECKPOINT.ASYNC:
        dist.barrier()
    return path


def save_best_checkpoint(model_sd: dict, epoch: int) -> str:
    """The weights-only ``best`` side-write alone, for the concurrent-eval
    join (the epoch checkpoint was committed at the boundary, the verdict
    arrives one epoch later); ``model_sd`` is the eval snapshot's."""
    path = get_best_checkpoint()
    if dist.is_primary():
        payload = _best_payload(_cpu(model_sd), epoch)
        _commit(os.path.basename(path),
                lambda durable: _write(path, payload, "weights", epoch, durable))
    if not cfg.CHECKPOINT.ASYNC:
        dist.barrier()
    return path


def save_preempt_checkpoint(state: dict, epoch: int, best_acc1: float,
                            pending_eval: int | None = None) -> str:
    """Mid-epoch save on preemption. ``epoch`` is the interrupted one; the
    stored cursor is ``epoch - 1`` so the resume re-runs that epoch from
    this newer state. ``pending_eval`` marks a finished epoch whose
    validation was preempted: the resume validates it first. Always
    synchronous, after joining the committer; the primary writes, behind
    a barrier."""
    committer.join_commits(reason="preemption")
    path = get_preempt_checkpoint(epoch)
    if dist.is_primary():
        payload = {**_cpu(state), "epoch": epoch - 1, "best_acc1": float(best_acc1)}
        if pending_eval is not None:
            payload["pending_eval"] = int(pending_eval)
        _write(path, payload, "full", epoch - 1)
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
