"""Preemption-safe training (counterpart of distribuuuu_tpu/utils/preempt.py).

With ``TRAIN.PREEMPT_SAVE`` the trainer installs a SIGTERM handler; the
epoch loop then stops at the next step boundary and writes a mid-epoch
checkpoint (``utils/checkpoint.save_preempt_checkpoint``) that auto-resume
prefers. The port runs one process, so the flag is local.
"""

from __future__ import annotations

import signal

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


def reset() -> None:
    _state["requested"] = False
