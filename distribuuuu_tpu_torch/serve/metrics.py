"""Serving observability: latency percentiles, batch occupancy, throughput.

Counterpart of distribuuuu_tpu/serve/metrics.py with the same
``snapshot()`` keys. Latency is measured enqueue → response demux. The
port has no telemetry registry yet (ROADMAP "Telemetry"), so the counters
and the bounded latency reservoir live here, behind one lock.
"""

from __future__ import annotations

import random
import threading
import time


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (0 < q ≤ 1)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[idx]


class ServeMetrics:
    """Thread-safe accumulator; one instance per observation window."""

    def __init__(self, max_samples: int = 65536):
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._lat: list[float] = []
        self._n_lat = 0
        self._c = dict.fromkeys(
            ("requests", "batches", "occ_filled", "occ_slots", "batch_s"), 0.0
        )
        self._t0 = time.perf_counter()

    def record_batch(self, n: int, bucket: int, batch_s: float,
                     latencies_s: list[float]) -> None:
        with self._lock:
            c = self._c
            c["requests"] += n
            c["batches"] += 1
            c["occ_filled"] += n
            c["occ_slots"] += bucket
            c["batch_s"] += batch_s
            for lat in latencies_s:
                self._n_lat += 1
                if len(self._lat) < self.max_samples:
                    self._lat.append(lat)
                else:  # reservoir sampling once full
                    j = random.randrange(self._n_lat)
                    if j < self.max_samples:
                        self._lat[j] = lat

    def mean_batch_ms(self) -> float:
        """Recent per-batch service time — drives retry-after estimates."""
        with self._lock:
            n_b = self._c["batches"]
            return self._c["batch_s"] / n_b * 1e3 if n_b else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            c = dict(self._c)
        n_b, slots = c["batches"], c["occ_slots"]
        window = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "requests": int(c["requests"]),
            "rejected": 0,  # rejections raise at submit; the engine counts none
            "batches": int(n_b),
            "throughput_rps": round(c["requests"] / window, 2),
            "p50_ms": round(percentile(lat, 0.50) * 1e3, 3),
            "p90_ms": round(percentile(lat, 0.90) * 1e3, 3),
            "p99_ms": round(percentile(lat, 0.99) * 1e3, 3),
            "mean_ms": round(sum(lat) / len(lat) * 1e3, 3) if lat else 0.0,
            "batch_occupancy": round(c["occ_filled"] / slots, 4) if slots else 0.0,
            "mean_batch_ms": round(c["batch_s"] / n_b * 1e3, 3) if n_b else 0.0,
            "window_s": round(window, 3),
        }
