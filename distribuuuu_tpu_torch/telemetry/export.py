"""Merge per-rank telemetry files onto one timebase and write a Chrome
trace-event JSON that Perfetto (ui.perfetto.dev) opens (the port's copy of
distribuuuu_tpu/telemetry/export.py): one process (pid) a rank, one track
(tid) a (rank, track) pair.

Inputs, each optional:

* ``{run}/telemetry/rank*.jsonl``: spans, compile (graph capture)
  records, mirrored resilience events (``telemetry/spans.py``). Span
  ``t0`` stamps are ``time.perf_counter`` seconds; each file's
  ``kind="clock"`` anchor maps them onto the unix timebase, so ranks with
  different monotonic origins align.
* ``{run}/metrics.jsonl``: the primary's per-batch ``kind="timeline"``
  records, on rank 0's clock, drawn as the ``loader`` (decode, assemble)
  and ``pipeline`` (wait, h2d, step) tracks of pid 0.

Event mapping: spans → ``ph:"X"`` (µs); compile → ``ph:"X"`` on the
``jit`` track, ending at ``mono``; stall/data_error/nonfinite → ``ph:"i"``
instants at their unix ``t``; ``trace.span`` → ``ph:"X"`` on a process of
its own a request (pid 1000 up), each span mapped through its own file's
anchor, the emitting rank in ``args``.
"""

from __future__ import annotations

import glob
import json
import os
import re


def read_jsonl(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line of a crashed run — keep the rest
    return recs


def rank_files(run_dir: str) -> dict[int, str]:
    """{rank: path} for every per-rank telemetry file under ``run_dir``."""
    out = {}
    for p in sorted(glob.glob(os.path.join(run_dir, "telemetry", "rank*.jsonl"))):
        m = re.fullmatch(r"rank(\d+)\.jsonl", os.path.basename(p))
        if m:
            out[int(m.group(1))] = p
    return out


def fleet_rank_files(run_dir: str) -> list[tuple[int, str, str]]:
    """[(pid, label, path)] for every per-rank telemetry file under
    ``run_dir``, INCLUDING the serving fleet's nested per-model dirs
    (``model_*/telemetry/rank*.jsonl`` — each replica process inherits a
    dumped cfg whose OUT_DIR is the model dir, so its sink lands there,
    not in the top-level telemetry dir). Top-level ranks keep
    ``pid == rank``; nested replica files take pids from 100 up so a
    fleet's replicas never collide with trainer ranks (synthetic
    per-request trace pids start at 1000)."""
    out = [(r, str(r), p) for r, p in sorted(rank_files(run_dir).items())]
    pid = 100
    for mdir in sorted(glob.glob(os.path.join(run_dir, "model_*"))):
        model = os.path.basename(mdir)[len("model_"):]
        pat = os.path.join(mdir, "telemetry", "rank*.jsonl")
        for p in sorted(glob.glob(pat)):
            m = re.fullmatch(r"rank(\d+)\.jsonl", os.path.basename(p))
            if m:
                out.append((pid, f"{model}/{m.group(1).lstrip('0') or '0'}", p))
                pid += 1
    return out


def _anchor(recs: list[dict]) -> tuple[float, float] | None:
    """(unix, mono) of the file's FIRST clock record (a restarted run
    appends a new anchor; each applies to the records after it — using
    the first keeps pre-restart records correct, and run segments are
    separated by the restart gap anyway)."""
    for r in recs:
        if r.get("kind") == "clock":
            return float(r["unix"]), float(r["mono"])
    return None


_INSTANT_KINDS = ("stall", "data_error", "nonfinite")
# timeline stage pairs -> (track, slice name)
_TIMELINE_SLICES = (
    ("get0", "get1", "pipeline", "wait"),
    ("put0", "put1", "pipeline", "h2d"),
    ("step0", "step1", "pipeline", "step"),
    ("dec0", "dec1", "loader", "decode"),
    ("dec1", "asm1", "loader", "assemble"),
)


class _Tracks:
    """Stable small-int tid per (pid, track-name), with name metadata."""

    def __init__(self):
        self._ids: dict[tuple[int, str], int] = {}
        self.meta: list[dict] = []

    def tid(self, pid: int, name: str) -> int:
        key = (pid, name)
        if key not in self._ids:
            tid = len([k for k in self._ids if k[0] == pid]) + 1
            self._ids[key] = tid
            self.meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name},
            })
        return self._ids[key]


def _span_args(rec: dict) -> dict:
    skip = {"kind", "rank", "t", "v", "name", "t0", "dur", "track"}
    return {k: v for k, v in rec.items() if k not in skip}


def merge_trace(run_dir: str) -> dict:
    """Chrome-trace dict for a finished run directory. Raises
    FileNotFoundError when neither telemetry files nor metrics.jsonl
    exist — there is nothing to trace."""
    files = fleet_rank_files(run_dir)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if not files and not os.path.exists(metrics_path):
        raise FileNotFoundError(
            f"no telemetry under {run_dir}: expected telemetry/rank*.jsonl "
            "(TELEMETRY.ENABLED) and/or metrics.jsonl (the jsonlog sink)"
        )
    tracks = _Tracks()
    events: list[dict] = []
    anchors: dict[int, tuple[float, float]] = {}
    # trace id -> anchor-mapped request spans (pids assigned at the end,
    # above the rank pid range, in first-seen order)
    trace_spans: dict[str, list[dict]] = {}

    for rank, label, path in files:
        recs = read_jsonl(path)
        anc = _anchor(recs)
        if anc is not None:
            anchors[rank] = anc
        events.append({
            "name": "process_name", "ph": "M", "pid": rank,
            "args": {"name": f"rank {label}"},
        })

        def to_us(mono: float) -> float:
            if anc is None:  # no anchor (torn file): mono origin, still ordered
                return mono * 1e6
            return (anc[0] + (mono - anc[1])) * 1e6

        for r in recs:
            kind = r.get("kind")
            if kind == "span":
                events.append({
                    "name": r.get("name", "?"), "ph": "X", "cat": "span",
                    "ts": round(to_us(float(r["t0"])), 3),
                    "dur": round(float(r["dur"]) * 1e6, 3),
                    "pid": rank,
                    "tid": tracks.tid(rank, str(r.get("track", "main"))),
                    "args": _span_args(r),
                })
            elif kind == "compile":
                dur_us = float(r["dur_s"]) * 1e6
                events.append({
                    "name": "compile", "ph": "X", "cat": "compile",
                    "ts": round(to_us(float(r["mono"])) - dur_us, 3),
                    "dur": round(dur_us, 3),
                    "pid": rank, "tid": tracks.tid(rank, "jit"),
                    "args": {"event": r.get("event", "")},
                })
            elif kind == "trace.span":
                tid_ = str(r.get("trace", ""))
                args = _span_args(r)
                args["rank"] = label
                trace_spans.setdefault(tid_, []).append({
                    "name": r.get("name", "?"), "ph": "X", "cat": "trace",
                    "ts": round(to_us(float(r["t0"])), 3),
                    "dur": round(float(r["dur"]) * 1e6, 3),
                    "args": args,
                })
            elif kind in _INSTANT_KINDS:
                events.append({
                    "name": kind, "ph": "i", "s": "p", "cat": "event",
                    "ts": round(float(r.get("t", 0.0)) * 1e6, 3),
                    "pid": rank, "tid": tracks.tid(rank, "events"),
                    "args": {k: v for k, v in r.items()
                             if k not in ("kind", "rank", "t")},
                })

    # primary metrics.jsonl timeline records: rank 0's clock places them
    if os.path.exists(metrics_path):
        anc0 = anchors.get(0)
        if not files:
            events.append({
                "name": "process_name", "ph": "M", "pid": 0,
                "args": {"name": "rank 0"},
            })
        for r in read_jsonl(metrics_path):
            if r.get("kind") != "timeline":
                continue
            for a, b, track, name in _TIMELINE_SLICES:
                if a not in r or b not in r:
                    continue
                t0, t1 = float(r[a]), float(r[b])
                ts = ((anc0[0] + (t0 - anc0[1])) if anc0 else t0) * 1e6
                events.append({
                    "name": name, "ph": "X", "cat": "timeline",
                    "ts": round(ts, 3), "dur": round((t1 - t0) * 1e6, 3),
                    "pid": 0, "tid": tracks.tid(0, track),
                    "args": {"phase": r.get("phase"), "epoch": r.get("epoch"),
                             "batch": r.get("batch"), "n": r.get("n")},
                })

    # one synthetic process per traced request, pids above the rank
    # range (ranks are small ints; 1000+ never collides)
    for i, (tid_, evs) in enumerate(sorted(trace_spans.items())):
        pid = 1000 + i
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"trace {tid_}"},
        })
        tid = tracks.tid(pid, "request")
        for ev in sorted(evs, key=lambda e: e["ts"]):
            ev["pid"] = pid
            ev["tid"] = tid
            events.append(ev)

    return {
        "traceEvents": tracks.meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "distribuuuu_tpu_torch telemetry/export.py",
                      "ranks": sorted({pid for pid, _, _ in files}
                                      | ({0} if os.path.exists(metrics_path)
                                         else set()))},
    }


def export_trace(run_dir: str, out_path: str | None = None) -> str:
    """Write the merged trace next to the run (default
    ``{run}/trace.json``); returns the path. Load it at ui.perfetto.dev
    or chrome://tracing."""
    trace = merge_trace(run_dir)
    out_path = out_path or os.path.join(run_dir, "trace.json")
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path
