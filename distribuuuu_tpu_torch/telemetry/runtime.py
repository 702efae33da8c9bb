"""Runtime capture: graph captures, kernel-library builds, card memory
(counterpart of distribuuuu_tpu/telemetry/runtime.py, JAX's compile
listener).

**Captures.** The port compiles nothing at run time; what stands in for a
backend compile is a CUDA graph capture (``graphs.StepGraph``: the body's
warm-up call, then the capture). :func:`on_capture` is called by the
graph once the capture is done, never inside it, on whichever thread made
the first call (the trainer, a serving batcher, the LM scheduler): it adds
to the registry's ``jit.compiles`` and ``jit.compile_s`` (JAX's names,
which ``tools/run_report.py`` and the replicas' ``stats()`` read) and
lands one ``kind="compile"`` record (``event "cuda_graph_capture"``,
``dur_s`` the warm-up and capture, ``mono`` its end). A recompile storm
(a shape drifting per step) shows as a run of these.

**The build cache.** A kernel library of ``ops/cuda/_build.py`` loaded
from ``_build/`` is a hit, one nvcc built is a miss: :func:`on_build`
counts ``jit.cache_hits``/``jit.cache_misses`` and lands a
``kind="compile.cache"`` record with the process's running tallies.

Both are installed by ``telemetry.setup_from_cfg`` under
``TELEMETRY.COMPILE_EVENTS`` and are no-ops while the sink is closed.

**Memory.** :func:`sample_memstats` reads ``torch.cuda.memory_stats`` of a
card (``allocated_bytes.all.current`` and ``.peak``) into one
``kind="memstats"`` record, once an epoch; a CPU device has none and is
skipped, as JAX skips its CPU backend. A graph's first call resets the
allocator's peak to measure itself (``cost.memory``), so the peak is the
highest since the last capture.
"""

from __future__ import annotations

import threading
import time

import torch

from distribuuuu_tpu_torch.telemetry import registry as registry_lib
from distribuuuu_tpu_torch.telemetry import spans

CAPTURE_EVENT = "cuda_graph_capture"

_state = {"installed": False, "hits": 0, "misses": 0}
_lock = threading.Lock()


def install_compile_listener() -> bool:
    """Turn the capture and build hooks on (idempotent)."""
    _state["installed"] = True
    return True


def uninstall_compile_listener() -> None:
    _state["installed"] = False


def on_capture(dur_s: float) -> None:
    """One finished graph capture of ``dur_s`` seconds (warm-up and
    capture), called after it, outside it."""
    if not (_state["installed"] and spans.enabled()):
        return
    reg = registry_lib.get_registry()
    reg.counter("jit.compiles").inc(1)
    reg.counter("jit.compile_s").inc(float(dur_s))
    spans.emit_event("compile", event=CAPTURE_EVENT, dur_s=round(float(dur_s), 6),
                     mono=round(time.perf_counter(), 6))


def on_build(name: str, hit: bool) -> None:
    """One kernel library ``name``: loaded from the build cache (``hit``)
    or built."""
    with _lock:
        _state["hits" if hit else "misses"] += 1
        hits, misses = _state["hits"], _state["misses"]
    if not (_state["installed"] and spans.enabled()):
        return
    registry_lib.get_registry().counter("jit.cache_hits" if hit else "jit.cache_misses").inc(1)
    spans.emit_event("compile.cache", event="hit" if hit else "miss", hits=hits, misses=misses,
                     library=name)


def sample_memstats(device, **attrs) -> int:
    """One ``kind="memstats"`` record for ``device`` when it is a card;
    returns the records written (0 on the CPU or with the sink closed)."""
    device = torch.device(device)
    if not spans.enabled() or device.type != "cuda":
        return 0
    stats = torch.cuda.memory_stats(device)
    spans.emit_event("memstats", device=device.index or 0,
                     bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
                     peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)), **attrs)
    return 1
