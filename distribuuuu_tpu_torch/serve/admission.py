"""Admission control and graceful drain for the serving engine (the port's
copy of distribuuuu_tpu/serve/admission.py, image-engine part).

* **Overload.** The ``AdmissionController`` bounds the queue at
  ``SERVE.MAX_QUEUE`` and rejects beyond it with a ``retry_after_ms`` hint,
  so overload does not turn into unbounded latency for every request.
* **Preemption.** SIGTERM sets a flag; the accept loop polls it, stops
  accepting, and the engine finishes every queued and in-flight request
  before the process exits.
"""

from __future__ import annotations

import signal


class QueueFullError(RuntimeError):
    """Request rejected: the admission queue is at ``SERVE.MAX_QUEUE``."""

    def __init__(self, depth: int, max_queue: int, retry_after_ms: float):
        super().__init__(
            f"serve queue full ({depth}/{max_queue}); "
            f"retry after ~{retry_after_ms:.0f} ms"
        )
        self.depth = depth
        self.max_queue = max_queue
        self.retry_after_ms = retry_after_ms


class EngineClosedError(RuntimeError):
    """Submitted after drain began — the engine no longer accepts work."""


class AdmissionController:
    """Bounded-queue admission: ``admit`` raises rather than letting the
    pending queue grow past ``max_queue``; ``close`` flips to
    reject-everything (drain mode)."""

    def __init__(self, max_queue: int):
        if max_queue < 1:
            raise ValueError(f"SERVE.MAX_QUEUE must be ≥ 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self._open = True

    @property
    def is_open(self) -> bool:
        return self._open

    def admit(self, depth: int, retry_after_ms: float) -> None:
        """Raise unless a request may join a queue currently ``depth`` deep."""
        if not self._open:
            raise EngineClosedError("engine is draining; not accepting requests")
        if depth >= self.max_queue:
            raise QueueFullError(depth, self.max_queue, retry_after_ms)

    def close(self) -> None:
        self._open = False


# -- SIGTERM → graceful drain -------------------------------------------------

_drain = {"requested": False}


def install_drain(signals=(signal.SIGTERM,)) -> None:
    """Install the drain handler (idempotent; main thread only). The handler
    only sets a flag, and chains to a previously installed handler."""

    def _make(prev):
        def handler(signum, frame):
            _drain["requested"] = True
            if callable(prev):
                prev(signum, frame)

        handler._dtpu_drain = True
        return handler

    for s in signals:
        prev = signal.getsignal(s)
        if getattr(prev, "_dtpu_drain", False):
            continue
        if prev in (signal.SIG_DFL, signal.SIG_IGN, None):
            prev = None
        signal.signal(s, _make(prev))


def drain_requested() -> bool:
    return _drain["requested"]

