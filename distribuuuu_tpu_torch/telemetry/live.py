"""Live observability plane: streaming tailer, windowed aggregates and
declarative alert rules (counterpart of distribuuuu_tpu/telemetry/live.py,
the same snapshots, alert records and Prometheus text): the
*during-the-run* half of the telemetry layer; ``telemetry/report.py`` is
the post-mortem half.

A port run's sinks (``{run}/telemetry/rank*.jsonl`` and the primary's
``metrics.jsonl``) are append-only JSONL files, so a second process can
watch a run without perturbing it. This module is that watcher:

    FileTailer      incremental tail of ONE JSONL file: byte-offset
                    based (never re-reads, never double-counts), holds a
                    torn trailing line until its newline arrives,
                    detects truncation/rotation and restarts cleanly,
                    and re-reads ``kind="clock"`` anchors (a restarted
                    run appends a new anchor mid-file).
    RunTailer       tails every rank sink under ``{run}/telemetry/``
                    (rescanning each poll, so a rank file that appears
                    LATE, an elastic resume or a replacement fleet
                    replica, is picked up) plus the primary ``metrics.jsonl``.
    LiveAggregator  streaming windowed aggregates over the tailed
                    records: cross-rank step p50/p90/p99 + straggler
                    skew, data-wait fraction, compile (graph capture)
                    deltas, resilience events, checkpoint durations, live
                    throughput, the SAME math ``telemetry/report.py``
                    applies post-mortem.
    probe_serve     one stats control-frame roundtrip to a serve
                    replica or fleet router (serve/protocol.py), with a
                    trailing-window latency read when the peer supports
                    it: live p99 / queue depth / occupancy.
    AlertRule /     the declarative rule engine: YAML rules, each with
    RuleEngine      window / threshold / hysteresis (consecutive breach
                    + clear windows) / dedup (an active alert does not
                    re-fire). Fired alerts are ``kind="alert"`` records.
    render_prometheus / MetricsHTTPServer
                    Prometheus text exposition of the latest snapshot,
                    served over HTTP for scraping.
    Monitor         the composition: tail -> aggregate -> probe -> rules ->
                    sink + dashboard. ``python -m
                    distribuuuu_tpu_torch.telemetry.live`` is the CLI;
                    ``soak.py`` drives it per interval.

The port has no dispatch sequencer, so no port run writes
``dispatch.wedge`` records and the ``dispatch-wedge`` rule never fires
on one; it stays declared and evaluable for JAX-shaped records.

Hard contract: the monitor only *reads* the run's files (os.stat + seek
+ read) and writes its own ``MONITOR.jsonl``: an attached monitor changes
no training bits (tests/test_torch_live.py).

The message and exposition strings (``MFU``, ``HBM headroom``, the
``dtpu_*`` metric names and their help texts) are the JAX package's
verbatim, so the two monitors' outputs compare byte for byte; on the card
"MFU" is the FLOP ledger's (``telemetry/costmodel.py``) and "HBM" the
card's memory.
"""

from __future__ import annotations

import glob
import http.server
import json
import os
import re
import socket
import threading
import time
from collections import deque

from distribuuuu_tpu_torch.telemetry import schema
from distribuuuu_tpu_torch.telemetry.registry import percentile

SNAPSHOT_SCHEMA = 1

# the rule kinds the engine knows how to evaluate
RULE_KINDS = (
    "recompile-storm",
    "stall",
    "nonfinite",
    "straggler-skew",
    "p99-breach",
    "throughput-regression",
    "mfu-regression",
    "hbm-headroom-low",
    "dispatch-wedge",
    "backpressure",
    "slo-breach",
    "degrade-spill",
)

_RANK_RE = re.compile(r"rank(\d+)\.jsonl$")


# ------------------------------------------------------------------ tailing
class FileTailer:
    """Incremental tail of one JSONL file.

    Invariants the edge-case tests pin (tests/test_torch_live.py):

    * a line is consumed exactly once — the byte offset only advances
      over COMPLETE (newline-terminated) lines, so a torn trailing line
      (the emitting process is mid-``write``) is buffered and parsed on
      a later poll when the rest arrives;
    * truncation (the file shrank) or rotation (a new inode at the same
      path) resets the tail to offset 0 — the monitor keeps running and
      ``resets`` counts the event;
    * ``kind="clock"`` anchors are re-read: the LATEST anchor seen maps
      mono stamps for the records that follow it (a restarted run
      appends a fresh anchor to its rank file).
    """

    def __init__(self, path: str, rank: int | None = None):
        self.path = path
        self.rank = rank
        self.anchor: tuple[float, float] | None = None  # latest (unix, mono)
        self.lines = 0  # complete lines consumed
        self.bad_lines = 0  # newline-terminated but not JSON
        self.resets = 0  # truncation/rotation restarts
        self._pos = 0  # byte offset of the next read
        self._buf = b""  # torn trailing line, carried across polls
        self._sig: tuple[int, int] | None = None  # (st_dev, st_ino)

    def poll(self) -> list[dict]:
        """All newly completed records since the last poll ([] when the
        file is absent or has nothing new)."""
        try:
            st = os.stat(self.path)
        except (FileNotFoundError, NotADirectoryError):
            return []
        sig = (st.st_dev, st.st_ino)
        if self._sig is not None and sig != self._sig:
            # rotated: a different file now lives at this path
            self._reset()
        elif st.st_size < self._pos:
            # truncated in place: our offset points past the new end
            self._reset()
        self._sig = sig
        if st.st_size == self._pos:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read(st.st_size - self._pos)
        except OSError:
            return []
        self._pos += len(chunk)
        data = self._buf + chunk
        lines = data.split(b"\n")
        self._buf = lines.pop()  # b"" on a clean newline-terminated tail
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            self.lines += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                self.bad_lines += 1
                continue
            if rec.get("kind") == "clock":
                # anchor re-read: later records map through the new pair
                try:
                    self.anchor = (float(rec["unix"]), float(rec["mono"]))
                except (KeyError, TypeError, ValueError):
                    pass
            out.append(rec)
        return out

    def _reset(self) -> None:
        self._pos = 0
        self._buf = b""
        self.resets += 1

    def to_unix(self, mono: float) -> float | None:
        if self.anchor is None:
            return None
        unix, anchor_mono = self.anchor
        return unix + (mono - anchor_mono)


class RunTailer:
    """Tails a whole run directory: every ``telemetry/rank*.jsonl`` (the
    set is RESCANNED each poll — a rank sink appearing mid-run is picked
    up from byte 0) plus the primary ``metrics.jsonl``.

    ``poll()`` returns ``(rank_records, primary_records)``; rank records
    carry their emitter's ``rank`` field already. Primary records are
    kept separate because the jsonlog mirror means event kinds exist in
    BOTH streams — consumers must count from exactly one (the aggregator
    uses rank sinks when any exist, telemetry/report.py's rule)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.tailers: dict[int, FileTailer] = {}
        self.primary = FileTailer(os.path.join(run_dir, "metrics.jsonl"))

    def rescan(self) -> list[int]:
        """Register tailers for rank files not seen before; returns the
        newly discovered ranks."""
        new = []
        pattern = os.path.join(self.run_dir, "telemetry", "rank*.jsonl")
        for path in sorted(glob.glob(pattern)):
            m = _RANK_RE.search(os.path.basename(path))
            if not m:
                continue
            rank = int(m.group(1))
            if rank not in self.tailers:
                self.tailers[rank] = FileTailer(path, rank=rank)
                new.append(rank)
        return new

    def poll(self) -> tuple[list[dict], list[dict]]:
        self.rescan()
        rank_records: list[dict] = []
        for rank in sorted(self.tailers):
            rank_records.extend(self.tailers[rank].poll())
        return rank_records, self.primary.poll()

    def health(self) -> dict:
        """Tailer-side counters for the snapshot (torn lines held, resets
        survived — the monitor's own proof it never crashed on an edge)."""
        ts = list(self.tailers.values()) + [self.primary]
        return {
            "files": len(self.tailers),
            "lines": sum(t.lines for t in ts),
            "bad_lines": sum(t.bad_lines for t in ts),
            "resets": sum(t.resets for t in ts),
        }


# ------------------------------------------------------------- aggregation
def _summary_ms(durs: list[float]) -> dict:
    """Same shape + math as telemetry/report.py's step summary (the
    parity test holds the two against each other)."""
    vals = sorted(durs)
    ms = 1e3
    return {
        "count": len(vals),
        "mean_ms": round(sum(vals) / len(vals) * ms, 3) if vals else 0.0,
        "p50_ms": round(percentile(vals, 0.50) * ms, 3),
        "p90_ms": round(percentile(vals, 0.90) * ms, 3),
        "p99_ms": round(percentile(vals, 0.99) * ms, 3),
        "max_ms": round(vals[-1] * ms, 3) if vals else 0.0,
    }


class _RankWindow:
    """One rank's accumulators for the current window."""

    def __init__(self):
        self.step_durs: list[float] = []
        self.fold_durs: list[float] = []  # already ÷ n (per-step seconds)
        self.steps = 0  # true optimizer steps (a fold span counts its n)
        self.images = 0
        self.wait_s = 0.0
        self.span_t0 = None  # pipeline-track coverage for wait fraction
        self.span_t1 = None
        self.step_t0 = None  # step-only coverage for live throughput
        self.step_t1 = None


class LiveAggregator:
    """Streaming windowed aggregates over tailed telemetry records.

    ``consume`` folds records in; ``snapshot`` closes the window, returns
    the aggregate dict (the ``kind="monitor.snapshot"`` payload), and
    opens the next one. Event counts follow telemetry/report.py's source rule:
    rank sinks are authoritative when any exist; the primary stream only
    counts for a telemetry-off (metrics.jsonl-only) run."""

    EVENT_KINDS = ("stall", "data_error", "nonfinite")

    def __init__(self, phase: str = "train"):
        self.phase = phase
        self._win: dict[int, _RankWindow] = {}
        self._events = dict.fromkeys(self.EVENT_KINDS, 0)
        self._compiles = 0
        self._compile_wall = 0.0
        self._ckpt_saves: list[float] = []
        self._ckpt_restores: list[float] = []
        self._wedges = 0  # dispatch.wedge records this window (sequencer)
        self._have_rank_sinks = False
        # cost-model ledger state (run-scope: a run emits each cost.*
        # record once, at first dispatch — it must survive window resets)
        self._flops_per_step: float | None = None
        self._peak_flops: float | None = None
        self._headroom_by_label: dict[str, float] = {}
        # run-scope tallies (survive window resets)
        self.totals = {
            "steps": 0, "images": 0, "compiles": 0,
            **{k: 0 for k in self.EVENT_KINDS},
        }

    def _rank_win(self, rank: int) -> _RankWindow:
        if rank not in self._win:
            self._win[rank] = _RankWindow()
        return self._win[rank]

    def consume(self, rank_records: list[dict],
                primary_records: list[dict] = ()) -> None:
        if rank_records:
            self._have_rank_sinks = True
        for rec in rank_records:
            self._one(rec, primary=False)
        for rec in primary_records:
            self._one(rec, primary=True)

    def _one(self, rec: dict, *, primary: bool) -> None:
        kind = rec.get("kind")
        if kind in self.EVENT_KINDS:
            # the mirror rule: count each event from exactly one stream
            if primary and self._have_rank_sinks:
                return
            self._events[kind] += 1
            self.totals[kind] += 1
            return
        if primary:
            return  # timeline/train/epoch records: display-only, not math
        if kind == "compile":
            self._compiles += 1
            self.totals["compiles"] += 1
            try:
                self._compile_wall += float(rec["dur_s"])
            except (KeyError, TypeError, ValueError):
                pass
            return
        if kind == "dispatch.wedge":
            # the sequencer's wedge watchdog flagged a stuck dispatcher
            # (asyncplane/sequencer.py) — the dispatch-wedge rule's input
            self._wedges += 1
            return
        if kind == "cost.step":
            # per-step flops + the resolved peak, for the live MFU read
            # (mfu-regression). Phase-matched; the latest record wins (a
            # resharded run re-emits its ledger).
            if rec.get("phase") == self.phase and rec.get("flops"):
                self._flops_per_step = float(rec["flops"])
                pk = rec.get("peak_flops")
                self._peak_flops = float(pk) if pk else None
            return
        if kind == "cost.memory":
            # headroom is per-executable; the alert cares about the
            # tightest one (min over labels) — hbm-headroom-low
            if rec.get("headroom_pct") is not None:
                self._headroom_by_label[str(rec.get("label"))] = float(
                    rec["headroom_pct"]
                )
            return
        if kind != "span":
            return
        name = rec.get("name")
        if name == "ckpt_save":
            self._ckpt_saves.append(float(rec["dur"]))
            return
        if name == "ckpt_restore":
            self._ckpt_restores.append(float(rec["dur"]))
            return
        if rec.get("phase") != self.phase:
            return
        rank = int(rec.get("rank", 0))
        win = self._rank_win(rank)
        t0 = float(rec.get("t0", 0.0))
        dur = float(rec.get("dur", 0.0))
        if rec.get("track") == "pipeline":
            win.span_t0 = t0 if win.span_t0 is None else min(win.span_t0, t0)
            win.span_t1 = (
                t0 + dur if win.span_t1 is None
                else max(win.span_t1, t0 + dur)
            )
        if name == "step":
            win.step_durs.append(dur)
            win.steps += 1
            win.images += int(rec.get("n", 0))
            self.totals["steps"] += 1
            self.totals["images"] += int(rec.get("n", 0))
        elif name == "fold_window":
            # a fold span's ``n`` is the STEP count of the window (the
            # batch size is not recorded there), so folded runs get
            # per-step time but no image throughput — img_per_sec stays
            # None and rate rules sit out via min_steps
            n = max(1, int(rec.get("n", 1)))
            win.fold_durs.append(dur / n)
            win.steps += n
            self.totals["steps"] += n
        elif name == "wait":
            win.wait_s += dur
            return
        else:
            return
        if name in ("step", "fold_window"):
            win.step_t0 = t0 if win.step_t0 is None else min(win.step_t0, t0)
            win.step_t1 = (
                t0 + dur if win.step_t1 is None
                else max(win.step_t1, t0 + dur)
            )

    def snapshot(self, window_s: float, serve: dict | None = None,
                 tail: dict | None = None) -> dict:
        """Close the current window into one aggregate dict and reset the
        window accumulators (run-scope ``totals`` roll on)."""
        # step percentiles: step spans when the window has any, else the
        # fold_window-derived per-step durations (telemetry/report.py's rule)
        pooled: list[float] = []
        per_rank_p50: dict[str, float] = {}
        images = 0
        true_steps = 0  # optimizer steps (fold spans count their n)
        active_t0, active_t1 = None, None
        wait_fracs: list[float] = []
        for rank, win in sorted(self._win.items()):
            durs = win.step_durs or win.fold_durs
            images += win.images
            true_steps += win.steps
            if durs:
                pooled.extend(durs)
                per_rank_p50[str(rank)] = round(
                    percentile(sorted(durs), 0.50) * 1e3, 3
                )
            if win.span_t0 is not None and win.span_t1 > win.span_t0:
                wait_fracs.append(win.wait_s / (win.span_t1 - win.span_t0))
            if win.step_t0 is not None:
                active_t0 = (
                    win.step_t0 if active_t0 is None
                    else min(active_t0, win.step_t0)
                )
                active_t1 = (
                    win.step_t1 if active_t1 is None
                    else max(active_t1, win.step_t1)
                )
        p50s = list(per_rank_p50.values())
        straggler = (
            round(max(p50s) / max(min(p50s), 1e-9), 4)
            if len(p50s) >= 2 else 1.0
        )
        # live throughput: images over the step-active span (first step
        # start → last step end INSIDE this window) — robust to windows
        # the run only partially occupies, and it sees host-side gaps
        # between steps (a slowdown), which images/sum(step_durs) cannot
        img_per_sec = None
        if images and active_t1 is not None and active_t1 > active_t0:
            img_per_sec = round(images / (active_t1 - active_t0), 2)
        # live measured MFU over the step-active span: flops/step
        # (cost.step ledger) × window steps ÷ span ÷ mesh peak — the
        # mfu-regression rule's input. None until both a ledger record
        # and a known device peak have been seen.
        mfu = None
        if (
            self._flops_per_step and self._peak_flops and true_steps
            and active_t1 is not None and active_t1 > active_t0
        ):
            mfu = round(
                self._flops_per_step * true_steps
                / (active_t1 - active_t0) / self._peak_flops, 4
            )
        headroom = (
            round(min(self._headroom_by_label.values()), 2)
            if self._headroom_by_label else None
        )
        snap = {
            "v": SNAPSHOT_SCHEMA,
            "window_s": round(float(window_s), 3),
            "ranks": len(self._win),
            "steps": len(pooled),
            "images": images,
            "img_per_sec": img_per_sec,
            "mfu": mfu,
            "hbm_headroom_pct": headroom,
            "step": _summary_ms(pooled),
            "per_rank_p50_ms": per_rank_p50,
            "straggler_skew": straggler,
            "data_wait_frac": (
                round(sum(wait_fracs) / len(wait_fracs), 4)
                if wait_fracs else None
            ),
            "compiles": {
                "count": self._compiles,
                "wall_s": round(self._compile_wall, 3),
            },
            "dispatch_wedges": self._wedges,
            "events": dict(self._events),
            "ckpt": {
                "saves": len(self._ckpt_saves),
                "save_max_s": round(max(self._ckpt_saves), 3)
                if self._ckpt_saves else 0.0,
                "restores": len(self._ckpt_restores),
            },
            "serve": serve,
            "totals": dict(self.totals),
        }
        if tail:
            snap["tail"] = tail
        self._win = {}
        self._events = dict.fromkeys(self.EVENT_KINDS, 0)
        self._compiles = 0
        self._compile_wall = 0.0
        self._ckpt_saves = []
        self._ckpt_restores = []
        self._wedges = 0
        return snap


# ------------------------------------------------------------ serve probe
def probe_serve(addr: tuple[str, int], window_s: float = 0.0,
                timeout: float = 2.0) -> dict | None:
    """One stats control-frame roundtrip to a serve replica or fleet
    router; returns a normalized dict or None when the peer is down (the
    monitor keeps running — a dead serve plane is itself a signal).

    ``window_s`` asks the peer for a trailing-window latency read
    (routers answer it; a bare replica returns its cumulative stats and
    the window fields fall back to those)."""
    from distribuuuu_tpu_torch.serve import protocol

    req = {"op": "stats"}
    if window_s:
        req["window_s"] = float(window_s)
    try:
        with socket.create_connection(addr, timeout=timeout) as conn:
            conn.settimeout(timeout)
            protocol.send_frame(
                conn, protocol.ctrl_request(req.pop("op"), **req)
            )
            payload = protocol.recv_frame(conn)
    except (OSError, ValueError):
        return None
    if payload is None:
        return None
    try:
        stats = json.loads(payload)
    except json.JSONDecodeError:
        return None
    win = stats.get("window") or {}
    per_replica = stats.get("per_replica")
    queue_depth = stats.get("queue_depth")
    occupancy = stats.get("batch_occupancy")
    if per_replica is not None:  # fleet router shape
        queue_depth = sum(int(p.get("queue_depth", 0)) for p in per_replica)
        occ = [float(p.get("occupancy", 0.0)) for p in per_replica
               if p.get("routable")]
        occupancy = round(sum(occ) / len(occ), 4) if occ else 0.0
    return {
        "p50_ms": float(win.get("p50_ms", stats.get("p50_ms", 0.0) or 0.0)),
        "p99_ms": float(win.get("p99_ms", stats.get("p99_ms", 0.0) or 0.0)),
        "window_samples": int(
            win.get("samples", stats.get("requests", 0) or 0)
        ),
        "queue_depth": int(queue_depth or 0),
        "occupancy": float(occupancy or 0.0),
        "requests": int(stats.get("requests", 0)),
        "rejected": int(stats.get("rejected", 0)),
        "degraded": int(stats.get("degraded", 0)),
        "replicas": int(stats.get("replicas", 1)),
        "routable": int(stats.get("routable", stats.get("replicas", 1) or 1)),
        # worst traced requests in the window (the router's exemplar
        # ring): what p99-breach/backpressure alerts name as
        # exemplar_trace_ids; empty against untraced peers
        "exemplars": win.get("exemplars") or [],
        "models": win.get("models") or {
            # cumulative fallback when the peer has no windowed view:
            # normalize the router's stats() model rows to the shape the
            # slo-breach rule reads
            name: {
                "samples": int(m.get("requests", 0)),
                "p99_ms": float(m.get("p99_ms", 0.0)),
                "target_ms": m.get("p99_slo_ms"),
            }
            for name, m in (stats.get("models") or {}).items()
        },
    }


# -------------------------------------------------------------- alert rules
class RuleError(ValueError):
    """A rule file / rule spec is invalid (soak --dry fails fast on it)."""


class AlertRule:
    """One declarative rule. Fields (YAML keys):

    kind             one of RULE_KINDS (required)
    threshold        breach level (required; counts for the event rules,
                     a ratio for straggler-skew, ms for p99-breach,
                     img/s floor fraction for throughput-regression)
    window_s         lookback the rule aggregates over (default: one
                     evaluation interval)
    breach_windows   consecutive breached evaluations before firing
                     (default 1)
    clear_windows    consecutive calm evaluations before an ACTIVE alert
                     clears and may fire again — the hysteresis half of
                     dedup (default 2)
    warmup_s         suppress evaluation for the first N seconds of
                     monitoring (default 0)
    min_steps        evaluate rate/skew rules only when the window saw at
                     least this many steps (default 1; filters windows a
                     run barely touches)
    baseline         throughput-regression / mfu-regression: the
                     reference img/s (resp. MFU); the rule breaches when
                     the live value falls below
                     ``baseline × (1 − threshold/100)``. Omitted ⇒ the
                     rule is declared but dormant.
    steady_only      recompile-storm only (default true): ignore windows
                     before the first step was seen — the startup
                     compile burst is not a storm.
    """

    _DEFAULTS = {
        "window_s": 0.0, "breach_windows": 1, "clear_windows": 2,
        "warmup_s": 0.0, "min_steps": 1, "baseline": None,
        "steady_only": True,
    }

    def __init__(self, spec: dict):
        if not isinstance(spec, dict):
            raise RuleError(f"rule spec must be a mapping, got {spec!r}")
        unknown = set(spec) - {"kind", "threshold", *self._DEFAULTS}
        if unknown:
            raise RuleError(
                f"rule {spec.get('kind', '?')!r}: unknown keys {sorted(unknown)}"
            )
        self.kind = spec.get("kind")
        if self.kind not in RULE_KINDS:
            raise RuleError(
                f"unknown rule kind {self.kind!r} (known: {', '.join(RULE_KINDS)})"
            )
        if "threshold" not in spec:
            raise RuleError(f"rule {self.kind!r}: 'threshold' is required")
        self.threshold = float(spec["threshold"])
        for key, default in self._DEFAULTS.items():
            val = spec.get(key, default)
            if key in ("breach_windows", "clear_windows", "min_steps"):
                val = int(val)
                if val < 1:
                    raise RuleError(f"rule {self.kind!r}: {key} must be >= 1")
            elif key in ("window_s", "warmup_s"):
                val = float(val)
                if val < 0:
                    raise RuleError(f"rule {self.kind!r}: {key} must be >= 0")
            elif key == "baseline" and val is not None:
                val = float(val)
            setattr(self, key, val)
        # engine state (dedup/hysteresis)
        self.breaches = 0
        self.calm = 0
        self.active = False
        self.fired = 0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "threshold": self.threshold,
            "window_s": self.window_s, "breach_windows": self.breach_windows,
            "clear_windows": self.clear_windows, "warmup_s": self.warmup_s,
            "min_steps": self.min_steps, "baseline": self.baseline,
            "steady_only": self.steady_only,
        }


def load_rules(path: str) -> list[AlertRule]:
    """Parse a YAML rules file: ``{"rules": [{kind, threshold, ...}]}``.
    Raises RuleError on anything malformed — ``soak --dry`` and
    ``monitor --dry`` surface this before any run starts."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("rules"), list):
        raise RuleError(f"{path}: expected a top-level 'rules:' list")
    rules = [AlertRule(spec) for spec in doc["rules"]]
    kinds = [r.kind for r in rules]
    dupes = {k for k in kinds if kinds.count(k) > 1}
    if dupes:
        raise RuleError(f"{path}: duplicate rule kinds {sorted(dupes)}")
    return rules


class RuleEngine:
    """Evaluates every rule against each window snapshot. Keeps a bounded
    snapshot history so a rule's ``window_s`` may span several evaluation
    intervals; owns the per-rule breach/clear/active state."""

    def __init__(self, rules: list[AlertRule], interval_s: float):
        self.rules = list(rules)
        self.interval_s = max(1e-3, float(interval_s))
        depth = 1
        for r in self.rules:
            depth = max(depth, self._lookback(r))
        # entries {"snap", "steady"}: steady marks windows that began
        # AFTER the first observed step — recompile-storm sums compiles
        # over steady entries only, so the startup compile burst never
        # counts, not even via a multi-window lookback
        self._history: deque[dict] = deque(maxlen=depth)
        self._t_start: float | None = None
        self._steps_before = 0  # cumulative steps before the current window

    def _lookback(self, rule: AlertRule) -> int:
        if rule.window_s <= 0:
            return 1
        return max(1, int(round(rule.window_s / self.interval_s)))

    def _value(self, rule: AlertRule, snap: dict,
               window: list[dict]) -> float | None:
        """The rule's observed value for this evaluation, or None when
        the rule cannot be evaluated (insufficient signal ≠ calm).
        ``window`` holds history entries ``{"snap", "steady"}``."""
        if rule.kind == "recompile-storm":
            entries = (
                [e for e in window if e["steady"]]
                if rule.steady_only else window
            )
            if not entries:
                return None  # startup burst: compiles before any step
            return float(
                sum(e["snap"]["compiles"]["count"] for e in entries)
            )
        if rule.kind == "stall":
            return float(sum(e["snap"]["events"]["stall"] for e in window))
        if rule.kind == "nonfinite":
            return float(
                sum(e["snap"]["events"]["nonfinite"] for e in window)
            )
        if rule.kind == "straggler-skew":
            if snap["steps"] < rule.min_steps or len(snap["per_rank_p50_ms"]) < 2:
                return None
            return float(snap["straggler_skew"])
        if rule.kind == "p99-breach":
            serve = snap.get("serve")
            if not serve or serve.get("window_samples", 0) < rule.min_steps:
                return None
            return float(serve["p99_ms"])
        if rule.kind == "throughput-regression":
            if rule.baseline is None:
                return None  # declared but dormant: no reference yet
            if snap["steps"] < rule.min_steps or snap["img_per_sec"] is None:
                return None
            return float(snap["img_per_sec"])
        if rule.kind == "mfu-regression":
            # live MFU (cost.step flops × steps / span / peak) below
            # baseline × (1 − threshold%); dormant until a baseline MFU
            # is set (soak/bench calibrate it) AND the run has emitted
            # its cost ledger + a known device peak (mfu non-None)
            if rule.baseline is None:
                return None
            if snap["steps"] < rule.min_steps or snap.get("mfu") is None:
                return None
            return float(snap["mfu"])
        if rule.kind == "hbm-headroom-low":
            # tightest executable headroom %; None until a cost.memory
            # record arrived (insufficient signal ≠ calm)
            hr = snap.get("hbm_headroom_pct")
            return None if hr is None else float(hr)
        if rule.kind == "dispatch-wedge":
            # sequencer wedge flags (kind="dispatch.wedge" records —
            # asyncplane/sequencer.py) over the lookback window
            return float(
                sum(e["snap"].get("dispatch_wedges", 0) for e in window)
            )
        if rule.kind in ("backpressure", "degrade-spill"):
            # growth of a cumulative serve counter over the lookback
            # window: rejected requests (backpressure) or degraded spills
            # to a fallback model (degrade-spill). Needs two serve-bearing
            # snapshots to form a delta — fewer is insufficient signal.
            key = "rejected" if rule.kind == "backpressure" else "degraded"
            vals = [
                e["snap"]["serve"].get(key, 0)
                for e in window if e["snap"].get("serve")
            ]
            if len(vals) < 2:
                return None
            return float(vals[-1] - vals[0])
        if rule.kind == "slo-breach":
            # worst per-model windowed p99 / SLO-target ratio (serve
            # campaigns register targets per model — fleet/router.py).
            # Models without a target or enough window samples don't vote.
            serve = snap.get("serve") or {}
            ratios = [
                float(m["p99_ms"]) / float(m["target_ms"])
                for m in (serve.get("models") or {}).values()
                if m.get("target_ms")
                and m.get("samples", 0) >= rule.min_steps
            ]
            return max(ratios) if ratios else None
        return None

    def _breached(self, rule: AlertRule, value: float) -> bool:
        if rule.kind in ("throughput-regression", "mfu-regression"):
            return value < rule.baseline * (1.0 - rule.threshold / 100.0)
        if rule.kind == "hbm-headroom-low":
            return value <= rule.threshold  # threshold is the floor %
        return value >= rule.threshold

    def _limit(self, rule: AlertRule) -> float:
        """The effective breach boundary, for the alert record."""
        if rule.kind in ("throughput-regression", "mfu-regression"):
            return round(rule.baseline * (1.0 - rule.threshold / 100.0), 3)
        return rule.threshold

    def evaluate(self, snap: dict) -> list[dict]:
        """Feed one window snapshot; returns the alerts that FIRE on this
        window (each a dict ready to be emitted as ``kind="alert"``)."""
        now = time.monotonic()
        if self._t_start is None:
            self._t_start = now
        self._history.append(
            {"snap": snap, "steady": self._steps_before > 0}
        )
        fired = []
        for rule in self.rules:
            if now - self._t_start < rule.warmup_s:
                continue
            window = list(self._history)[-self._lookback(rule):]
            value = self._value(rule, snap, window)
            if value is None:
                continue
            if self._breached(rule, value):
                rule.breaches += 1
                rule.calm = 0
                if rule.breaches >= rule.breach_windows and not rule.active:
                    # dedup: one alert per excursion — stays active until
                    # clear_windows calm evaluations pass
                    rule.active = True
                    rule.fired += 1
                    alert = {
                        "rule": rule.kind,
                        "value": round(value, 4),
                        "threshold": self._limit(rule),
                        "window_s": rule.window_s or self.interval_s,
                        "breach_windows": rule.breach_windows,
                        "message": self._message(rule, value),
                    }
                    if rule.kind in ("p99-breach", "backpressure"):
                        # exemplar attribution: name the worst <= 3
                        # traced requests of the breaching window so
                        # the alert points at concrete trace ids;
                        # also land one trace.exemplar record per id in
                        # the per-rank sink (no-op, telemetry off)
                        exs = ((snap.get("serve") or {})
                               .get("exemplars") or [])[:3]
                        if exs:
                            alert["exemplar_trace_ids"] = [
                                e["trace"] for e in exs
                            ]
                            from distribuuuu_tpu_torch.telemetry import spans

                            for e in exs:
                                spans.emit_event(
                                    "trace.exemplar", v=1,
                                    rule=rule.kind, trace=e["trace"],
                                    latency_ms=e["latency_ms"],
                                )
                    fired.append(alert)
            else:
                rule.breaches = 0
                if rule.active:
                    rule.calm += 1
                    if rule.calm >= rule.clear_windows:
                        rule.active = False
                        rule.calm = 0
        self._steps_before = snap["totals"]["steps"]
        return fired

    def _message(self, rule: AlertRule, value: float) -> str:
        limit = self._limit(rule)
        if rule.kind == "throughput-regression":
            return (f"throughput {value:.1f} img/s fell below "
                    f"{limit:.1f} (baseline {rule.baseline:.1f} "
                    f"- {rule.threshold:.0f}%)")
        if rule.kind == "mfu-regression":
            return (f"measured MFU {value:.4f} fell below {limit:.4f} "
                    f"(baseline {rule.baseline:.4f} "
                    f"- {rule.threshold:.0f}%)")
        if rule.kind == "hbm-headroom-low":
            return (f"HBM headroom {value:.1f}% at or under the "
                    f"{limit:g}% floor (tightest executable)")
        unit = {
            "p99-breach": " ms", "straggler-skew": "x", "slo-breach": "x",
        }.get(rule.kind, "")
        return f"{rule.kind}: {value:g}{unit} >= {limit:g}{unit}"

    def active_rules(self) -> list[str]:
        return [r.kind for r in self.rules if r.active]

    def fired_counts(self) -> dict[str, int]:
        return {r.kind: r.fired for r in self.rules}


# ----------------------------------------------------------- Prometheus
def render_prometheus(snap: dict, engine: RuleEngine | None = None) -> str:
    """Prometheus text exposition (format 0.0.4) of one snapshot. Output
    order is fixed — the golden test compares verbatim."""
    lines = []

    def gauge(name, value, help_s, labels=""):
        lines.append(f"# HELP {name} {help_s}")
        lines.append(f"# TYPE {name} gauge")
        if isinstance(value, list):
            lines.extend(f"{name}{lb} {v}" for lb, v in value)
        else:
            lines.append(f"{name}{labels} {value}")

    def counter(name, value, help_s):
        lines.append(f"# HELP {name} {help_s}")
        lines.append(f"# TYPE {name} counter")
        if isinstance(value, list):
            lines.extend(f"{name}{lb} {v}" for lb, v in value)
        else:
            lines.append(f"{name} {value}")

    s = snap["step"]
    gauge("dtpu_step_ms",
          [(f'{{quantile="{q}"}}', s[f"{q}_ms"]) for q in ("p50", "p90", "p99")],
          "cross-rank step time quantiles over the last window (ms)")
    gauge("dtpu_steps_window", snap["steps"],
          "steps observed in the last window")
    gauge("dtpu_straggler_skew", snap["straggler_skew"],
          "slowest/fastest rank p50 step time over the last window")
    gauge("dtpu_data_wait_frac",
          snap["data_wait_frac"] if snap["data_wait_frac"] is not None else 0.0,
          "fraction of the pipeline wall spent waiting on data")
    gauge("dtpu_img_per_sec",
          snap["img_per_sec"] if snap["img_per_sec"] is not None else 0.0,
          "live throughput over the step-active span of the last window")
    # cost-model gauges appear once the run has emitted its ledger
    # (conditional like the serve block — absent, not 0, before then)
    if snap.get("mfu") is not None:
        gauge("dtpu_mfu", snap["mfu"],
              "measured MFU over the last window (XLA cost-model flops)")
    if snap.get("hbm_headroom_pct") is not None:
        gauge("dtpu_hbm_headroom_pct", snap["hbm_headroom_pct"],
              "tightest executable HBM headroom percent")
    # sequencer wedge flags appear only once one fired (conditional like
    # the cost-model gauges — the golden exposition stays unchanged)
    if snap.get("dispatch_wedges"):
        gauge("dtpu_dispatch_wedges", snap["dispatch_wedges"],
              "dispatch-sequencer wedge flags in the last window")
    counter("dtpu_steps_total", snap["totals"]["steps"],
            "steps observed since the monitor attached")
    counter("dtpu_recompiles_total", snap["totals"]["compiles"],
            "backend compile events since the monitor attached")
    counter(
        "dtpu_events_total",
        [(f'{{kind="{k}"}}', snap["totals"][k])
         for k in LiveAggregator.EVENT_KINDS],
        "resilience events since the monitor attached",
    )
    serve = snap.get("serve")
    if serve:
        gauge("dtpu_serve_p99_ms", serve["p99_ms"],
              "serve latency p99 over the probe window (ms)")
        gauge("dtpu_serve_queue_depth", serve["queue_depth"],
              "total queued work across the serve plane")
        gauge("dtpu_serve_occupancy", serve["occupancy"],
              "mean batch occupancy of routable replicas")
        gauge("dtpu_serve_routable", serve["routable"],
              "routable replica count")
    if engine is not None:
        counter(
            "dtpu_alerts_total",
            [(f'{{rule="{k}"}}', v)
             for k, v in sorted(engine.fired_counts().items())],
            "alerts fired per rule since the monitor attached",
        )
        active = set(engine.active_rules())
        gauge(
            "dtpu_alert_active",
            [(f'{{rule="{r.kind}"}}', 1 if r.kind in active else 0)
             for r in sorted(engine.rules, key=lambda r: r.kind)],
            "1 while the rule's alert is active (hysteresis window)",
        )
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Tiny threaded HTTP endpoint serving the latest exposition text at
    ``/metrics`` (anything else 404s). ``update(text)`` swaps the page
    atomically; ``port`` is resolved after start (0 ⇒ ephemeral)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._text = b"# monitor starting\n"
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = outer._text
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dtpu-metrics-http",
            daemon=True,
        )

    def start(self) -> "MetricsHTTPServer":
        self._thread.start()
        return self

    def update(self, text: str) -> None:
        self._text = text.encode()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# -------------------------------------------------------------- the monitor
class MonitorSink:
    """The monitor's OWN output file (``{run}/MONITOR.jsonl`` by
    default) — deliberately not a ``rank*.jsonl`` name, so telemetry/report.py /
    export never mistake the watcher's records for the run's. Every
    record is validated against the declared schema before it is
    written."""

    def __init__(self, path: str | None):
        self.path = path
        self._f = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def emit_event(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "t": round(time.time(), 3), **fields}
        schema.validate_record(rec)
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Monitor:
    """Tail → aggregate → probe → rules → sink, once per ``tick()``.

    Read-only toward the run (the neutrality contract); writes its own
    MONITOR.jsonl (``sink_path``; None keeps it off-disk for library
    use). ``serve_addr`` adds the serve-plane probe; ``prometheus`` is an
    optional MetricsHTTPServer kept fed with the latest exposition."""

    def __init__(
        self,
        run_dir: str,
        engine: RuleEngine,
        *,
        phase: str = "train",
        serve_addr: tuple[str, int] | None = None,
        sink_path: str | None = "__default__",
        prometheus: MetricsHTTPServer | None = None,
    ):
        self.run_dir = run_dir
        self.engine = engine
        self.tailer = RunTailer(run_dir)
        self.agg = LiveAggregator(phase=phase)
        self.serve_addr = serve_addr
        if sink_path == "__default__":
            sink_path = os.path.join(run_dir, "MONITOR.jsonl")
        self.sink = MonitorSink(sink_path)
        self.prometheus = prometheus
        self.alerts: list[dict] = []  # every alert fired over the lifetime
        self._last_tick = time.monotonic()

    def tick(self) -> dict:
        """One monitoring interval: returns {"snapshot", "alerts"}."""
        now = time.monotonic()
        window_s = max(now - self._last_tick, 1e-6)
        self._last_tick = now
        rank_recs, primary_recs = self.tailer.poll()
        self.agg.consume(rank_recs, primary_recs)
        serve = None
        if self.serve_addr is not None:
            serve = probe_serve(self.serve_addr, window_s=window_s)
        snap = self.agg.snapshot(window_s, serve=serve,
                                 tail=self.tailer.health())
        fired = self.engine.evaluate(snap)
        self.sink.emit_event("monitor.snapshot", **snap)
        for alert in fired:
            self.sink.emit_event("alert", **alert)
        self.alerts.extend(fired)
        if self.prometheus is not None:
            self.prometheus.update(render_prometheus(snap, self.engine))
        return {"snapshot": snap, "alerts": fired}

    def run(self, interval_s: float, *, duration_s: float = 0.0,
            should_stop=None, on_tick=None) -> None:
        """Tick every ``interval_s`` until ``duration_s`` elapses (0 =
        forever) or ``should_stop()`` goes true. One final tick drains
        whatever the tailed files received after the loop condition."""
        t_end = time.monotonic() + duration_s if duration_s else None
        while True:
            if should_stop is not None and should_stop():
                break
            if t_end is not None and time.monotonic() >= t_end:
                break
            time.sleep(interval_s)
            out = self.tick()
            if on_tick is not None:
                on_tick(out)
        out = self.tick()  # drain the tail
        if on_tick is not None:
            on_tick(out)

    def close(self) -> None:
        self.sink.close()


# ------------------------------------------------------------ CLI dashboard
def format_dashboard(snap: dict, engine: RuleEngine,
                     recent_alerts: list[dict]) -> str:
    """The live terminal view: one compact block per tick."""
    s = snap["step"]
    lines = [
        time.strftime("%H:%M:%S")
        + f"  window {snap['window_s']:.1f}s  ranks {snap['ranks']}"
        + f"  steps {snap['steps']}  (total {snap['totals']['steps']})",
        f"  step ms   p50 {s['p50_ms']:>9.2f}  p90 {s['p90_ms']:>9.2f}"
        f"  p99 {s['p99_ms']:>9.2f}  max {s['max_ms']:>9.2f}",
        f"  skew {snap['straggler_skew']:<7g}"
        f" wait_frac {snap['data_wait_frac'] if snap['data_wait_frac'] is not None else 'n/a'}"
        f"  img/s {snap['img_per_sec'] if snap['img_per_sec'] is not None else 'n/a'}"
        f"  mfu {snap.get('mfu') if snap.get('mfu') is not None else 'n/a'}"
        f"  hbm {str(snap['hbm_headroom_pct']) + '%' if snap.get('hbm_headroom_pct') is not None else 'n/a'}"
        f"  compiles +{snap['compiles']['count']}"
        f" (total {snap['totals']['compiles']})",
        "  events   "
        + "  ".join(f"{k}={snap['events'][k]}"
                    for k in LiveAggregator.EVENT_KINDS)
        + f"  ckpt saves +{snap['ckpt']['saves']}"
          f" (max {snap['ckpt']['save_max_s']}s)",
    ]
    serve = snap.get("serve")
    if serve:
        lines.append(
            f"  serve    p99 {serve['p99_ms']:.1f}ms"
            f"  queue {serve['queue_depth']}"
            f"  occupancy {serve['occupancy']:.2f}"
            f"  routable {serve['routable']}/{serve['replicas']}"
        )
    active = engine.active_rules()
    lines.append(
        "  alerts   active: " + (", ".join(active) if active else "none")
        + "   fired: "
        + (", ".join(f"{k}×{v}" for k, v in engine.fired_counts().items()
                     if v) or "none")
    )
    for a in recent_alerts:
        lines.append(f"  ⚠ ALERT {a['rule']}: {a['message']}")
    return "\n".join(lines)


def _parse_addr(text: str) -> tuple[str, int]:
    host, _, port = text.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv=None) -> int:
    """``python -m distribuuuu_tpu_torch.telemetry.live``: the CLI of
    ``tools/monitor.py``, with its flags."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Live run monitor: tail telemetry sinks, evaluate "
                    "alert rules, expose Prometheus metrics, draw a "
                    "terminal dashboard.",
    )
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="run OUT_DIR to watch (telemetry/rank*.jsonl)")
    ap.add_argument("--rules", default=None, metavar="RULES.yaml",
                    help="alert rules file (default: "
                         "config/monitor_rules.yaml next to the repo)")
    ap.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="also probe a serve replica/fleet router's stats "
                         "endpoint each interval")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="evaluation interval seconds (default 5)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="stop after this many seconds (default: run "
                         "until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="one tick over whatever is on disk, print, exit")
    ap.add_argument("--prometheus-port", type=int, default=0,
                    metavar="PORT", help="serve /metrics on this port "
                    "(0 = disabled; -1 = ephemeral, port printed)")
    ap.add_argument("--json-lines", action="store_true",
                    help="print one snapshot JSON per tick instead of "
                         "the dashboard")
    ap.add_argument("--dry", action="store_true",
                    help="validate the rules file and exit (no run "
                         "directory needed)")
    args = ap.parse_args(argv)

    rules_path = args.rules
    if rules_path is None:
        rules_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "config", "monitor_rules.yaml"
        )
    try:
        rules = load_rules(rules_path)
    except (OSError, RuleError) as e:
        print(f"monitor: invalid rules file: {e}")
        return 1
    if args.dry:
        print(f"monitor --dry: {len(rules)} rule(s) OK in {rules_path}: "
              + ", ".join(r.kind for r in rules))
        return 0
    if args.run_dir is None or not os.path.isdir(args.run_dir):
        ap.error(f"need a run directory (got {args.run_dir!r})")

    engine = RuleEngine(rules, interval_s=args.interval)
    prom = None
    if args.prometheus_port:
        port = 0 if args.prometheus_port < 0 else args.prometheus_port
        prom = MetricsHTTPServer(port=port).start()
        print(f"monitor: /metrics on http://{prom.host}:{prom.port}/metrics")
    serve_addr = _parse_addr(args.serve) if args.serve else None
    mon = Monitor(args.run_dir, engine, serve_addr=serve_addr,
                  prometheus=prom)
    print(f"monitor: watching {args.run_dir} every {args.interval:g}s "
          f"({len(rules)} rules from {os.path.basename(rules_path)}); "
          f"alerts -> {mon.sink.path}")

    def on_tick(out):
        if args.json_lines:
            print(json.dumps(out["snapshot"]))
        else:
            print(format_dashboard(out["snapshot"], engine, out["alerts"]))

    try:
        if args.once:
            on_tick(mon.tick())
        else:
            mon.run(args.interval, duration_s=args.duration,
                    on_tick=on_tick)
    except KeyboardInterrupt:
        pass
    finally:
        mon.close()
        if prom is not None:
            prom.stop()
    n = len(mon.alerts)
    print(f"monitor: done — {n} alert(s) fired"
          + (": " + ", ".join(a["rule"] for a in mon.alerts) if n else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
