"""Autoscale-from-telemetry: the fleet-sizing policy loop (counterpart of
distribuuuu_tpu/serve/fleet/autoscale.py, the same policy and records).

The policy consumes exactly what the telemetry layer already measures —
the router's windowed latency percentiles (the same reservoir +
nearest-rank math every Registry histogram reports) and total queued work
— and moves the pool's target size against a p99 objective with
queue-depth watermarks: the scaling signal is end-to-end run health
(client p99, queued work), never per-kernel speed.

Hysteresis, because a serving fleet must not flap:

* **Consecutive-breach gating** — one bad window never scales; it takes
  ``BREACH_N`` consecutive over-target windows (p99 > target OR queue >
  high watermark) to add a replica, and ``BREACH_N`` consecutive calm
  windows (p99 < SCALE_DOWN_FRAC x target AND queue <= low watermark) to
  remove one. Any in-between window resets both streaks.
* **Cooldown** — after any action the policy holds for ``COOLDOWN_S``
  (a new replica needs its warm-up before its effect is measurable;
  scaling again on the same evidence double-counts it).
* **Budget clamp** — the target never leaves
  [MIN_REPLICAS, MAX_REPLICAS].

``AutoscalePolicy.decide`` is a pure function of (time, observation) —
the fast test tier drives the hysteresis math directly, no processes.
``Autoscaler`` is the thread that feeds it router observations every
``EVAL_PERIOD_S`` and applies decisions through ``pool.scale_to``,
emitting a ``kind="fleet.scale"`` telemetry record per action.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from distribuuuu_tpu_torch.utils.logger import get_logger


@dataclass
class Observation:
    """One autoscaler input window (from ``Router.window_stats``)."""

    p99_ms: float
    queue_depth: int
    n_replicas: int
    samples: int = 0


class AutoscalePolicy:
    """The pure hysteresis math. ``decide(now_s, obs)`` returns +1
    (add a replica), -1 (remove one), or 0."""

    def __init__(
        self,
        *,
        p99_target_ms: float,
        queue_high: int,
        queue_low: int,
        scale_down_frac: float = 0.5,
        breach_n: int = 3,
        cooldown_s: float = 10.0,
        min_replicas: int = 1,
        max_replicas: int = 4,
    ):
        if not 0.0 < scale_down_frac < 1.0:
            raise ValueError(
                f"SCALE_DOWN_FRAC must be in (0, 1), got {scale_down_frac} "
                "(>= 1 would scale down while still breaching the target)"
            )
        if min_replicas > max_replicas:
            raise ValueError(
                f"MIN_REPLICAS {min_replicas} > MAX_REPLICAS {max_replicas}"
            )
        self.p99_target_ms = float(p99_target_ms)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self.scale_down_frac = float(scale_down_frac)
        self.breach_n = int(breach_n)
        self.cooldown_s = float(cooldown_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: float | None = None
        self.last_reason = ""

    def _overloaded(self, obs: Observation) -> bool:
        return (
            obs.p99_ms > self.p99_target_ms
            or obs.queue_depth > self.queue_high
        )

    def _calm(self, obs: Observation) -> bool:
        # an idle window (no samples) is calm by definition — idle fleets
        # shrink to the minimum budget
        return (
            obs.p99_ms < self.scale_down_frac * self.p99_target_ms
            and obs.queue_depth <= self.queue_low
        )

    def decide(self, now_s: float, obs: Observation) -> int:
        in_cooldown = (
            self._last_action_t is not None
            and now_s - self._last_action_t < self.cooldown_s
        )
        # streaks accumulate through cooldown (the evidence is real), but
        # no ACTION fires until the cooldown expires
        if self._overloaded(obs):
            self._up_streak += 1
            self._down_streak = 0
        elif self._calm(obs):
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if in_cooldown:
            return 0
        if (
            self._up_streak >= self.breach_n
            and obs.n_replicas < self.max_replicas
        ):
            self.last_reason = (
                f"p99 {obs.p99_ms:.0f} ms / queue {obs.queue_depth} over "
                f"target for {self._up_streak} windows"
            )
            self._acted(now_s)
            return +1
        if (
            self._down_streak >= self.breach_n
            and obs.n_replicas > self.min_replicas
        ):
            self.last_reason = (
                f"p99 {obs.p99_ms:.0f} ms / queue {obs.queue_depth} calm "
                f"for {self._down_streak} windows"
            )
            self._acted(now_s)
            return -1
        return 0

    def _acted(self, now_s: float) -> None:
        self._last_action_t = now_s
        self._up_streak = self._down_streak = 0


class Autoscaler:
    """The policy loop thread: observe the router, decide, act through
    the pool, record the action in telemetry."""

    def __init__(self, router, pool, policy: AutoscalePolicy,
                 *, eval_period_s: float = 2.0):
        self.router = router
        self.pool = pool
        self.policy = policy
        self.eval_period_s = float(eval_period_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.logger = get_logger()

    def observe(self) -> Observation:
        w = self.router.window_stats(2 * self.eval_period_s)
        return Observation(
            p99_ms=w["p99_ms"],
            queue_depth=w["queue_depth"],
            n_replicas=self.pool.target_size,
            samples=w["samples"],
        )

    def step(self, now_s: float | None = None) -> int:
        """One observe->decide->act iteration (public for tests)."""
        from distribuuuu_tpu_torch.telemetry import spans

        now_s = time.perf_counter() if now_s is None else now_s
        obs = self.observe()
        d = self.policy.decide(now_s, obs)
        if d:
            n_before = self.pool.target_size
            n_after = self.pool.scale_to(n_before + d, wait=False)
            action = "scale_up" if d > 0 else "scale_down"
            self.logger.info(
                "fleet: autoscale %s %d -> %d (%s)",
                action, n_before, n_after, self.policy.last_reason,
            )
            spans.emit_event(
                "fleet.scale", action=action, reason=self.policy.last_reason,
                n_before=n_before, n_after=n_after,
            )
        return d

    def _loop(self) -> None:
        while not self._stop.wait(self.eval_period_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must not die
                self.logger.exception("fleet: autoscaler iteration failed")

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.eval_period_s + 5)
