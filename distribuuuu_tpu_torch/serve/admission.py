"""Admission control and graceful drain for the serving engines (the port's
copy of distribuuuu_tpu/serve/admission.py).

* **Overload.** The ``AdmissionController`` bounds the queue at
  ``SERVE.MAX_QUEUE`` and rejects beyond it with a ``retry_after_ms`` hint,
  so overload does not turn into unbounded latency for every request. The
  LM engine also caps the queue share long prompts may hold
  (``SERVE.LONG_MAX_QUEUE``): a burst of long prefills backpressures the
  long class while short requests keep being admitted.
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


class LongQueueFullError(QueueFullError):
    """Long-class rejection: the long-prompt reservation
    (``SERVE.LONG_MAX_QUEUE``) is exhausted while short-class capacity may
    remain. A :class:`QueueFullError`, so every layer that catches it keeps
    the queue_full frame; only the message and ``length_class`` differ."""

    def __init__(self, class_depth: int, long_max_queue: int,
                 max_queue: int, retry_after_ms: float):
        RuntimeError.__init__(
            self,
            f"serve queue full for long prompts ({class_depth}/"
            f"{long_max_queue} long-class slots; SERVE.MAX_QUEUE="
            f"{max_queue}); retry after ~{retry_after_ms:.0f} ms"
        )
        self.depth = class_depth
        self.max_queue = long_max_queue
        self.retry_after_ms = retry_after_ms
        self.length_class = "long"


class EngineClosedError(RuntimeError):
    """Submitted after drain began — the engine no longer accepts work."""


class AdmissionController:
    """Bounded-queue admission: ``admit`` raises rather than letting the
    pending queue grow past ``max_queue``; ``close`` flips to
    reject-everything (drain mode). ``long_max_queue`` caps the queue
    slots long-class requests may hold: a long request needs a free slot
    and a free long-class slot, a short one only a free slot, so at least
    ``max_queue - long_max_queue`` slots stay reachable for short traffic."""

    def __init__(self, max_queue: int, long_max_queue: int = 0):
        if max_queue < 1:
            raise ValueError(f"SERVE.MAX_QUEUE must be ≥ 1, got {max_queue}")
        long_max_queue = int(long_max_queue or 0)
        if long_max_queue < 0:
            raise ValueError(
                f"SERVE.LONG_MAX_QUEUE must be ≥ 0, got {long_max_queue}"
            )
        if long_max_queue >= max_queue and long_max_queue:
            raise ValueError(
                f"SERVE.LONG_MAX_QUEUE={long_max_queue} must leave "
                f"short-class headroom below SERVE.MAX_QUEUE={max_queue} "
                f"({long_max_queue} >= {max_queue}) — lower LONG_MAX_QUEUE "
                "or raise MAX_QUEUE"
            )
        self.max_queue = int(max_queue)
        self.long_max_queue = long_max_queue
        self._open = True

    @property
    def is_open(self) -> bool:
        return self._open

    def admit(self, depth: int, retry_after_ms: float, *,
              length_class: str = "short", class_depth: int = 0) -> None:
        """Raise unless a request may join a queue currently ``depth``
        deep; a long-class request also passes ``class_depth``, the long
        requests queued, which the reservation bounds."""
        if not self._open:
            raise EngineClosedError("engine is draining; not accepting requests")
        if depth >= self.max_queue:
            raise QueueFullError(depth, self.max_queue, retry_after_ms)
        if self.long_max_queue and length_class == "long" \
                and class_depth >= self.long_max_queue:
            raise LongQueueFullError(class_depth, self.long_max_queue, self.max_queue,
                                     retry_after_ms)

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

