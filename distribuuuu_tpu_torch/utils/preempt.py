"""Preemption-safe training (counterpart of distribuuuu_tpu/utils/preempt.py).

With ``TRAIN.PREEMPT_SAVE`` the trainer installs a SIGTERM handler; the
epoch loop then stops at the next step boundary and writes a mid-epoch
checkpoint (``utils/checkpoint.save_preempt_checkpoint``) that auto-resume
prefers. Each process may see the signal at another moment and the save
is collective, so with several processes the loop asks
``requested_global()``, the OR of every process's flag (one all-reduce),
and every process leaves at the same boundary.
"""

from __future__ import annotations

import signal

import torch

from distribuuuu_tpu_torch.parallel import dist

_state = {"requested": False}


def install(signals=(signal.SIGTERM,)) -> None:
    """Install the handler (idempotent), chaining to any handler that was
    there before."""

    def _make(prev):
        def handler(signum, frame):
            _state["requested"] = True
            if callable(prev):
                prev(signum, frame)

        handler._dtpu_torch_preempt = True
        return handler

    for s in signals:
        prev = signal.getsignal(s)
        if getattr(prev, "_dtpu_torch_preempt", False):
            continue
        signal.signal(s, _make(prev if prev not in (signal.SIG_DFL, signal.SIG_IGN) else None))


def requested() -> bool:
    return _state["requested"]


def requested_global() -> bool:
    """True when any process has seen the signal; every process gets the
    same answer. The local flag when there is one process."""
    if dist.get_world_size() == 1:
        return requested()
    flag = torch.tensor([1.0 if requested() else 0.0], device=dist.collective_device())
    torch.distributed.all_reduce(flag)
    return bool(flag.item() > 0)


def reset() -> None:
    _state["requested"] = False
