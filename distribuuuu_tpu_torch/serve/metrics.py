"""Serving observability: latency percentiles, batch occupancy, throughput
(counterpart of distribuuuu_tpu/serve/metrics.py, the same ``snapshot()``
keys).

Latency is measured enqueue → response demux. The meters are the
telemetry registry's instruments (``telemetry/registry.py``): each
``ServeMetrics`` owns a ``Registry`` of its own, because it is a bounded
observation window (a bench installs a fresh one per load point); pass
``registry=`` to aggregate into another. ``emit()`` lands a snapshot as
one ``kind="serve"`` record through ``utils/jsonlog.metrics_log``.
"""

from __future__ import annotations

import time

from distribuuuu_tpu_torch.telemetry.registry import Registry, percentile
from distribuuuu_tpu_torch.utils.jsonlog import metrics_log


class ServeMetrics:
    """Thread-safe accumulator; one instance per observation window."""

    def __init__(self, max_samples: int = 65536, registry: Registry | None = None):
        self.max_samples = max_samples
        self.registry = registry or Registry()
        self._lat = self.registry.histogram("serve.latency_s", max_samples)
        self._t0 = time.perf_counter()

    def record_batch(self, n: int, bucket: int, batch_s: float,
                     latencies_s: list[float]) -> None:
        reg = self.registry
        reg.counter("serve.requests").inc(n)
        reg.counter("serve.batches").inc(1)
        reg.counter("serve.occ_filled").inc(n)
        reg.counter("serve.occ_slots").inc(bucket)
        reg.counter("serve.batch_s").inc(batch_s)
        for lat in latencies_s:
            self._lat.observe(lat)

    def record_rejection(self) -> None:
        self.registry.counter("serve.rejected").inc(1)

    def _count(self, name: str) -> float:
        return self.registry.counter(name).value

    def mean_batch_ms(self) -> float:
        """Recent per-batch service time — drives retry-after estimates."""
        n_b = self._count("serve.batches")
        return self._count("serve.batch_s") / n_b * 1e3 if n_b else 0.0

    def snapshot(self) -> dict:
        lat = self._lat.values()  # the sorted reservoir
        n_req = self._count("serve.requests")
        n_b = self._count("serve.batches")
        filled, slots = self._count("serve.occ_filled"), self._count("serve.occ_slots")
        batch_s = self._count("serve.batch_s")
        window = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "requests": int(n_req),
            "rejected": int(self._count("serve.rejected")),
            "batches": int(n_b),
            "throughput_rps": round(n_req / window, 2),
            "p50_ms": round(percentile(lat, 0.50) * 1e3, 3),
            "p90_ms": round(percentile(lat, 0.90) * 1e3, 3),
            "p99_ms": round(percentile(lat, 0.99) * 1e3, 3),
            "mean_ms": round(sum(lat) / len(lat) * 1e3, 3) if lat else 0.0,
            "batch_occupancy": round(filled / slots, 4) if slots else 0.0,
            "mean_batch_ms": round(batch_s / n_b * 1e3, 3) if n_b else 0.0,
            "window_s": round(window, 3),
        }

    def emit(self, **extra) -> None:
        """One ``kind="serve"`` record of the snapshot (a no-op without a
        sink; mirrored to the rank's own sink)."""
        metrics_log("serve", **self.snapshot(), **extra)
