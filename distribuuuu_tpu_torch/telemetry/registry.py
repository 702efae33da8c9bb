"""Process-wide metrics registry: counters, gauges, histograms
(counterpart of distribuuuu_tpu/telemetry/registry.py, the same snapshot
schema).

Instruments are get-or-create by name (``get_registry().counter(
"jit.compiles")`` from anywhere returns the same object), thread-safe,
and snapshot into a plain dict that :func:`emit_snapshot` lands in the
per-rank sink as one ``kind="registry"`` record; ``tools/run_report.py``
reads the last snapshot of each rank.

The port's counters, by name: ``jit.compiles``/``jit.compile_s`` (CUDA
graph captures and their warm-up and capture seconds,
``telemetry/runtime.py``), ``jit.cache_hits``/``jit.cache_misses`` (kernel
library loads from ``_build/`` and nvcc builds), ``data.batches``,
``data.samples``, ``data.decode_s``, ``data.errors`` (``data/loader.py``),
``shards.records``, ``shards.bytes`` (``data/shards/reader.py``),
``resilience.nonfinite``, ``resilience.stalls``
(``resilience/supervisor.py``), ``serve.aot_compiles`` (graphs captured by
the serving engines' warm-ups); each serving window's own registry holds
``serve.*`` and the ``serve.latency_s`` histogram.

Histogram percentiles: exact count/sum/min/max plus a bounded reservoir
with nearest-rank percentiles, as ``serve/metrics.ServeMetrics`` reports.
Once a reservoir is full its replacement draws come from a generator of
the registry's own (``random.Random``), never from Python's global
``random``: telemetry moves no stream a run reads.
"""

from __future__ import annotations

import random
import threading

REGISTRY_SCHEMA = 1


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (0 < q ≤ 1)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[idx]


class Counter:
    """Monotonic accumulator (int or float increments)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value-wins instrument."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact count/sum/min/max plus a bounded reservoir for percentiles
    (reservoir sampling once full, from ``rng``)."""

    def __init__(self, name: str, max_samples: int = 65536, rng: random.Random | None = None):
        self.name = name
        self.max_samples = max_samples
        self._rng = rng or random.Random(0)
        self._lock = threading.Lock()
        self._vals: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._vals) < self.max_samples:
                self._vals.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self._vals[j] = v

    def values(self) -> list[float]:
        with self._lock:
            return sorted(self._vals)

    def summary(self) -> dict:
        vals = self.values()
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": round(self.min, 6) if self.min is not None else 0.0,
            "max": round(self.max, 6) if self.max is not None else 0.0,
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "p50": round(percentile(vals, 0.50), 6),
            "p90": round(percentile(vals, 0.90), 6),
            "p99": round(percentile(vals, 0.99), 6),
        }


class Registry:
    """Named instrument store. The process-global instance
    (:func:`get_registry`) backs the train and runtime counters; windowed
    consumers (``ServeMetrics``) make their own. Its histograms share one
    generator, seeded 0."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, max_samples: int = 65536) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(name, max_samples, self._rng)
            return self._hists[name]

    def snapshot(self) -> dict:
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.summary() for n, h in self._hists.items()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_global = Registry()


def get_registry() -> Registry:
    return _global


def emit_snapshot(**extra) -> None:
    """The global registry's snapshot as one ``kind="registry"`` record
    in the per-rank sink (one an epoch and one at a run's end; run_report
    reads the last of each rank)."""
    from distribuuuu_tpu_torch.telemetry import spans

    spans.emit_event("registry", v=REGISTRY_SCHEMA, **_global.snapshot(), **extra)
