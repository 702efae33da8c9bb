"""Per-rank telemetry sink and span API (counterpart of
distribuuuu_tpu/telemetry/spans.py, the same records).

Every process (rank) appends one JSON object a line to its own file,
``{dir}/rank{NNNNN}.jsonl``; unlike ``utils/jsonlog.py``'s primary-only
``metrics.jsonl``, a rank's own signals (a straggler's step times, a
stall on rank 3) survive on every rank and merge later
(``telemetry/export.py``, ``tools/run_report.py``).

Two clocks, bridged per file:

* ``t``: ``time.time()`` unix seconds (every record's envelope);
* ``t0``: ``time.perf_counter()`` seconds (spans: the clock of the
  trainer's timeline stamps, so intervals are exact).

The first record of every file is a ``kind="clock"`` anchor, one
(unix, mono) pair sampled back to back; the exporter maps a file's mono
stamps onto the unix timebase through it.

Telemetry changes no trained bit and no served token: nothing here
touches a generator, a device tensor or the training state. A module
singleton, as the JAX package's: ``setup_telemetry`` (through
``telemetry.setup_from_cfg``) in ``train_model``, ``test_model`` and
``serve_net``, then ``span()``/``emit_event()`` from anywhere; a cheap
no-op until set up. The loader pool, the LM scheduler, the committer,
concurrent eval's thread and the heartbeat emit concurrently.

**One writer thread.** A caller puts its record (a fresh dict) on a
queue; one writer thread serialises and writes what the queue holds
into the file, a batch at a time, flushing after each (at most every
``WRITE_INTERVAL_S``), in the order the records were queued. JAX writes
each record line-buffered on the caller's thread; on the card that cost
the LM scheduler 28 % of its tokens/s (a serialisation and a write
syscall on every decode step's record), so the port moves both off every
emitting thread: the writer does them while the emitters wait on the
card. A crashed run loses at most the last interval's records. :func:`flush` waits
until every line queued so far is in the file; :func:`close_telemetry`
drains and closes.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from contextlib import contextmanager

SPAN_SCHEMA = 1
WRITE_INTERVAL_S = 0.05  # the writer's pause between batches

_sink = {"f": None, "rank": 0, "path": None, "q": None, "writer": None, "error": None}
_lock = threading.Lock()  # guards opening and closing the sink
_tls = threading.local()  # the per-thread span stack (nesting depth, track)
_STOP = object()


def _jsonable(x):
    """A field json cannot take: a numpy scalar's value, else its str."""
    item = getattr(x, "item", None)
    return item() if callable(item) else str(x)


def _write_loop(f, q: queue.SimpleQueue) -> None:
    """The writer thread: serialise and write what ``q`` holds into ``f``
    a batch at a time, in order; set each flush marker (an Event) once the
    records before it are written; end at the stop marker. A failed write
    is kept in ``_sink["error"]`` (raised by :func:`flush` and
    :func:`close_telemetry`) and the queue is still drained."""
    while True:
        batch = [q.get()]
        while True:
            try:
                batch.append(q.get_nowait())
            except queue.Empty:
                break
        lines, done, stop = [], [], False
        for item in batch:
            if isinstance(item, dict):
                lines.append(json.dumps(item, default=_jsonable) + "\n")
            elif item is _STOP:
                stop = True
            else:
                done.append(item)
        if lines and _sink["error"] is None:
            try:
                f.write("".join(lines))
                f.flush()
            except OSError as e:
                _sink["error"] = e
        for ev in done:
            ev.set()
        if stop:
            return
        time.sleep(WRITE_INTERVAL_S)


def _raise_write_error() -> None:
    err, _sink["error"] = _sink["error"], None
    if err is not None:
        raise RuntimeError(f"telemetry sink write failed: {err}") from err


def setup_telemetry(tdir: str, rank: int = 0) -> str:
    """Open (append) this rank's sink ``{tdir}/rank{NNNNN}.jsonl`` and
    write the clock anchor; returns the path. A directory that cannot be
    made or a file that cannot be opened raises here. There is no primary
    gate: per-rank files are the point."""
    close_telemetry()
    os.makedirs(tdir, exist_ok=True)
    path = os.path.join(tdir, f"rank{int(rank):05d}.jsonl")
    with _lock:
        f = open(path, "a")
        q = queue.SimpleQueue()
        writer = threading.Thread(target=_write_loop, args=(f, q), daemon=True,
                                  name="dtpu-telemetry-writer")
        writer.start()
        _sink.update(f=f, rank=int(rank), path=path, q=q, writer=writer, error=None)
    # (unix, mono) sampled back to back: the exporter's timebase bridge
    emit_event("clock", unix=round(time.time(), 6), mono=round(time.perf_counter(), 6))
    return path


def enabled() -> bool:
    return _sink["f"] is not None


def flush() -> None:
    """Wait until every record emitted so far is in the file."""
    q = _sink["q"]
    if _sink["f"] is None or q is None:
        return
    ev = threading.Event()
    q.put(ev)
    ev.wait()
    _raise_write_error()


def close_telemetry() -> None:
    """Write what is queued, stop the writer, close the file."""
    with _lock:
        if _sink["f"] is not None:
            f, q, writer = _sink["f"], _sink["q"], _sink["writer"]
            _sink.update(f=None, path=None, q=None, writer=None)
            q.put(_STOP)
            writer.join()
            f.close()
    _raise_write_error()


def emit_event(kind: str, **fields) -> None:
    """Append one record ``{"kind", "rank", "t", **fields}``; a no-op
    until ``setup_telemetry`` ran. Every ``kind`` is declared in
    ``telemetry/schema.py``."""
    q = _sink["q"]
    if q is None:
        return
    rec = {"kind": kind, "rank": _sink["rank"], "t": round(time.time(), 3)}
    rec.update(fields)
    q.put(rec)


def mirror_event(kind: str, fields: dict) -> None:
    """The jsonlog bridge: ``utils/jsonlog.metrics_log`` forwards every
    record here, so a rank's own kinds (stall, data_error, nonfinite)
    survive on ranks > 0. ``timeline`` is left out: those records stay in
    the primary's ``metrics.jsonl``, where the exporter reads them."""
    if _sink["f"] is None or kind == "timeline":
        return
    emit_event(kind, **fields)


def emit_span(name: str, t0: float, t1: float, *, track: str = "main", **attrs) -> None:
    """One finished span from ``time.perf_counter`` stamps taken before
    (the trainer measures first and writes after, so the write never sits
    inside the interval). ``track`` groups spans into one Perfetto line a
    (rank, track)."""
    if _sink["f"] is None:
        return
    emit_event("span", v=SPAN_SCHEMA, name=name, t0=round(t0, 6), dur=round(t1 - t0, 6),
               track=track, **attrs)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextmanager
def span(name: str, *, track: str | None = None, **attrs):
    """A span with nesting: depth and parent come from a per-thread
    stack, so ``span("ckpt_commit")`` inside another span renders nested
    and carries ``depth``/``parent``; a nested span inherits its parent's
    track. One truthiness check when telemetry is off."""
    if _sink["f"] is None:
        yield
        return
    st = _stack()
    if track is None:
        track = st[-1][1] if st else f"thread-{threading.get_ident() % 10000}"
    st.append((name, track))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        st.pop()
        extra = {"depth": len(st), "parent": st[-1][0]} if st else {}
        emit_span(name, t0, t1, track=track, **attrs, **extra)
