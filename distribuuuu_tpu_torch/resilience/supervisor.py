"""In-run failure supervision (counterpart of distribuuuu_tpu/resilience/supervisor.py):
the non-finite loss policy and the stall watchdog.

``TRAIN.NONFINITE``:

* ``raise``: fail at the next metric flush (``PRINT_FREQ``) with
  :class:`NonFiniteLossError`; steps dispatch without a host sync between
  flushes.
* ``skip``: the poisoned update is discarded and the state before the step
  is kept (parameters, optimizer state and BN running stats; the step
  cursor still advances). The trainer reads the loss's finiteness after
  every forward for this, one host sync per step.
* ``rollback``: raise as ``raise`` does; ``trainer.train_model`` catches
  the error, reloads the last intact checkpoint and re-runs from there,
  at most ``TRAIN.MAX_ROLLBACKS`` times. A deterministic NaN re-trips and
  surfaces once the budget is spent.

With several processes the flag is the global loss's, so every process
raises at the same flush.

``TRAIN.STALL_TIMEOUT`` (seconds, 0 = off): :class:`Heartbeat` warns when
no step lands within the window; :func:`watch_blocking` warns when a
blocking wait outside the epoch loop (the checkpoint committer's join)
lasts that long. Flag, not kill. Each flag adds to the registry's
``resilience.stalls`` and lands a ``stall`` record; each non-finite step
adds to ``resilience.nonfinite`` and lands a ``nonfinite`` record (through
``utils/jsonlog.metrics_log``, mirrored to the rank's own sink).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from distribuuuu_tpu_torch.telemetry import registry as telemetry_registry
from distribuuuu_tpu_torch.utils.jsonlog import metrics_log
from distribuuuu_tpu_torch.utils.logger import get_logger

NONFINITE_POLICIES = ("raise", "skip", "rollback")


class NonFiniteLossError(RuntimeError):
    """The loss went NaN/Inf and the policy was not ``skip`` (or the
    rollback budget ran out). Carries the position."""

    def __init__(self, epoch: int, batch: int, value: float):
        super().__init__(
            f"non-finite loss ({value}) at epoch {epoch + 1}, batch ~{batch}. "
            "Policy TRAIN.NONFINITE: 'raise' (this), 'skip' (discard the step), "
            "'rollback' (reload the last intact checkpoint)"
        )
        self.epoch = epoch
        self.batch = batch
        self.value = value


def validate_policy(policy: str) -> str:
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"TRAIN.NONFINITE={policy!r}: must be one of {NONFINITE_POLICIES}")
    return policy


class NonFiniteMonitor:
    """Host half of the policy: reads the fetched ``nonfinite`` flags at
    flush time; counts and logs under ``skip``, raises under ``raise`` and
    ``rollback`` (the trainer's loop catches the latter)."""

    def __init__(self, policy: str, epoch: int, logger=None):
        self.policy = validate_policy(policy)
        self.epoch = epoch
        self.logger = logger or get_logger()
        self.skipped = 0

    def observe(self, loss: float, nonfinite: float, batch: int) -> bool:
        """True when this step was skipped (keep it out of the meters)."""
        if not nonfinite:
            return False
        telemetry_registry.get_registry().counter("resilience.nonfinite").inc(1)
        if self.policy == "skip":
            self.skipped += 1
            self.logger.warning(
                "non-finite loss at epoch %d batch ~%d — update skipped "
                "(TRAIN.NONFINITE=skip; %d skipped so far)",
                self.epoch + 1, batch, self.skipped,
            )
            metrics_log("nonfinite", epoch=self.epoch + 1, batch=batch, skipped=self.skipped,
                        policy="skip")
            return True
        metrics_log("nonfinite", epoch=self.epoch + 1, batch=batch, policy=self.policy)
        raise NonFiniteLossError(self.epoch, batch, loss)


@contextmanager
def watch_blocking(label: str, timeout: float, logger=None):
    """Warn once when the wrapped block lasts more than ``timeout``
    seconds; ``timeout <= 0`` starts no thread."""
    timeout = float(timeout)
    if timeout <= 0:
        yield
        return
    logger = logger or get_logger()
    done = threading.Event()
    t0 = time.monotonic()

    def _watch():
        while not done.wait(min(timeout / 4.0, 1.0)):
            age = time.monotonic() - t0
            if age > timeout:
                logger.warning("blocked in %s for %.1fs (threshold %.1fs): hung storage "
                               "or a wedged background commit", label, age, timeout)
                telemetry_registry.get_registry().counter("resilience.stalls").inc(1)
                metrics_log("stall", age_s=round(age, 3), last=label, count=1)
                return

    watcher = threading.Thread(target=_watch, daemon=True, name="dtpu-block-watch")
    watcher.start()
    try:
        yield
    finally:
        done.set()
        watcher.join(timeout=2.0)


class Heartbeat:
    """Flags when no ``beat()`` arrives within ``timeout`` seconds, once
    per stall. ``timeout <= 0`` starts no thread; ``beat``/``stop`` are
    then no-ops."""

    def __init__(self, timeout: float, logger=None):
        self.timeout = float(timeout)
        self.logger = logger or get_logger()
        self.stall_count = 0
        self._last = time.monotonic()
        self._label = "start"
        self._flagged_at = 0.0
        self._stop = threading.Event()
        self._thread = None
        if self.timeout > 0:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dtpu-heartbeat")
            self._thread.start()

    def beat(self, label: str = "") -> None:
        self._last = time.monotonic()
        if label:
            self._label = label

    def _run(self) -> None:
        poll = max(min(self.timeout / 4.0, 1.0), 0.01)
        while not self._stop.wait(poll):
            last = self._last
            age = time.monotonic() - last
            if age > self.timeout and last != self._flagged_at:
                self._flagged_at = last
                self.stall_count += 1
                self.logger.warning(
                    "heartbeat: no step progress for %.1fs (last: %s; "
                    "TRAIN.STALL_TIMEOUT=%.1fs): a wedged collective, a dead peer, "
                    "or hung storage", age, self._label, self.timeout)
                telemetry_registry.get_registry().counter("resilience.stalls").inc(1)
                metrics_log("stall", age_s=round(age, 3), last=self._label,
                            count=self.stall_count)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
