"""Train+serve soak referee (counterpart of distribuuuu_tpu/soak.py, with
the flags of tools/soak.py).

Composes the port's subsystems into the production scenario they exist
for: shards-backed training runs with deterministic ``FAULTS.*``
injection, a serving fleet answering Poisson background traffic and
hot-reloading checkpoints as epochs complete, and the LIVE monitor
(``telemetry/live.py``) watching every interval; then referees the whole
thing into one machine-readable verdict:

* every injected fault class must raise EXACTLY its expected
  ``kind="alert"`` record (and nothing else);
* the clean control interval must raise ZERO alerts;
* ``telemetry/report.py`` regression gates are evaluated per interval
  against the control interval's report (intervals that inject a
  regression are EXPECTED to fail their gate: the gate catching them is
  the proof);
* the monitored control run must be bit-identical to an unmonitored
  rerun of the same config (trajectory neutrality, checked leaf by leaf
  over the two ``.pth`` checkpoints in a fresh interpreter). Each
  training run sets ``CUDNN.DETERMINISTIC`` and turns ``CUDNN.BENCHMARK``
  off: on the card, without them, two runs of one config need not agree
  and the check would mean nothing.

Every interval trains under ``TRAIN.NONFINITE skip`` (the nonfinite
interval's policy; the JAX worker leaves the default): on the card that
policy reads each step's non-finite flag on the host, one sync a step,
which puts the step's device time into its ``step`` span, where the
default policy's span is the graph's dispatch alone. One policy for all
intervals keeps the per-interval gate comparing one clock.

Interval matrix (``--smoke`` keeps the first two; fault batch indices
scale with the corpus so every injection lands inside the epoch):

    control           no faults            expects no alert, gate n/a
    nonfinite         FAULTS.NAN_STEP      expects {nonfinite}, gate PASS
    stall             FAULTS.STALL_*       expects {stall}, gate PASS
    recompile_storm   FAULTS.RECOMPILE_*   expects {recompile-storm},
                                           gate FAIL (recompiles count);
                                           the card only (CUDA graph
                                           captures)
    slowdown          FAULTS.SLOWDOWN_*    expects {throughput-regression},
                                           gate FAIL (img/s)
    p99_burst         open-loop overload   expects {p99-breach} (serve
                                           plane only, no train)

Straggler-skew is not injected: on a lockstep data-parallel run every
rank's step span includes the collective wait, so a host-side sleep on
one rank slows every rank's measured step equally; the rule is held on
synthetic multi-rank sinks in tests/test_torch_live.py instead.

Host-dependent thresholds are calibrated, not guessed: the throughput
baseline is the control interval's own live rate, and the serve p99
threshold comes from background-traffic latency observed while training
runs. Each train interval is a fresh interpreter.

Trailing ``KEY VALUE`` pairs override every training interval's and the
serve plane's config; training and serving run on the card unless they
say ``DEVICE.PLATFORM cpu``.

    python -m distribuuuu_tpu_torch.soak --out SOAK.json   # the full matrix
    python -m distribuuuu_tpu_torch.soak --smoke            # control + nonfinite
    python -m distribuuuu_tpu_torch.soak --smoke --serve    # + the fleet, hot-reloaded
    python -m distribuuuu_tpu_torch.soak --dry              # validate, run nothing
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from distribuuuu_tpu_torch.telemetry.live import (
    AlertRule,
    Monitor,
    MonitorSink,
    RuleEngine,
    load_rules,
)

SOAK_SCHEMA = 1
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os
import sys

import distribuuuu_tpu_torch.config as config
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.ops import cuda as kernel_tier

out_dir = sys.argv[1]
config.reset_cfg()
cfg.MODEL.ARCH = "resnet18"
cfg.MODEL.NUM_CLASSES = 4
cfg.DEVICE.COMPUTE_DTYPE = "float32"
cfg.CUDNN.DETERMINISTIC = True
cfg.CUDNN.BENCHMARK = False
cfg.TRAIN.NONFINITE = "skip"
cfg.TRAIN.BATCH_SIZE = 4
cfg.TRAIN.IM_SIZE = 32
cfg.TRAIN.PRINT_FREQ = 16
cfg.TEST.BATCH_SIZE = 8
cfg.TEST.IM_SIZE = 32
cfg.DATA.FORMAT = "shards"
cfg.DATA.SHARDS_BLOCK = 4
cfg.DATA.SHARDS_WINDOW = 16
cfg.OPTIM.MAX_EPOCH = 1
cfg.RNG_SEED = 0
cfg.OUT_DIR = out_dir
if len(sys.argv) > 2:
    cfg.merge_from_list(sys.argv[2:])
best = trainer.train_model()
print(f"SOAK_RUN_DONE best={best:.3f} launches={kernel_tier.launch_counts()}", flush=True)
# everything the soak reads is written and closed: skip the interpreter's
# teardown (module cleanup, the card's context), seconds a run
os._exit(0)
"""

# fresh-interpreter checkpoint comparison: argv = ckpt_a ckpt_b; exits 0
# iff every leaf of both payloads is BIT-identical
COMPARE = """
import sys

import torch


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


la = dict(leaves(torch.load(sys.argv[1], map_location="cpu", weights_only=True)))
lb = dict(leaves(torch.load(sys.argv[2], map_location="cpu", weights_only=True)))
assert sorted(la) == sorted(lb), f"leaves {sorted(set(la) ^ set(lb))[:5]} differ"
diff = sum(
    0 if (torch.equal(la[k], lb[k]) if torch.is_tensor(la[k]) else la[k] == lb[k]) else 1
    for k in la
)
print(f"COMPARE leaves={len(la)} diff={diff}", flush=True)
sys.exit(0 if diff == 0 else 1)
"""


def _platform(opts) -> str:
    opts = [str(o) for o in opts]
    for i in range(0, len(opts) - 1, 2):
        if opts[i] == "DEVICE.PLATFORM" and opts[i + 1] == "cpu":
            return "cpu"
    return "cuda"


def make_corpus(work: str, per_class: int) -> tuple[str, int]:
    """Synthetic 4-class imagefolder packed into REAL record shards by the
    port's packer; returns (shards_root, train_batches)."""
    import numpy as np
    from PIL import Image

    from distribuuuu_tpu_torch.data.shards.format import pack_imagefolder

    src = os.path.join(work, "imagefolder")
    rng = np.random.default_rng(0)
    for split, n in (("train", per_class), ("val", max(4, per_class // 8))):
        for c in range(4):
            d = os.path.join(src, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = rng.integers(0, 256, size=(48, 56, 3), dtype=np.uint8)
                arr[:, :, c % 3] |= 0x80
                Image.fromarray(arr).save(
                    os.path.join(d, f"img{i}.jpg"), "JPEG", quality=90
                )
    out = os.path.join(work, "shards")
    pack_imagefolder(src, out, target_bytes=64 * 1024)
    return out, per_class * 4 // 4  # batch size 4, 4 classes


def interval_matrix(n_batches: int) -> list[dict]:
    """The train intervals; fault batch indices scale with the corpus so
    injections land mid-epoch at any ``--per-class``."""
    nan_at = max(2, int(n_batches * 0.30))
    stall_at = max(3, int(n_batches * 0.60))
    recompile_at = max(3, int(n_batches * 0.45))
    return [
        {"name": "control", "overrides": (), "expected": [],
         "expected_gate": None},
        {"name": "nonfinite", "expected": ["nonfinite"],
         "expected_gate": "pass",
         "overrides": ("TRAIN.NONFINITE", "skip", "FAULTS.ENABLED", "True",
                       "FAULTS.NAN_STEP", nan_at)},
        {"name": "stall", "expected": ["stall"], "expected_gate": "pass",
         "overrides": ("TRAIN.STALL_TIMEOUT", 0.6, "FAULTS.ENABLED", "True",
                       "FAULTS.STALL_EPOCH", 0,
                       "FAULTS.STALL_AT_BATCH", stall_at,
                       "FAULTS.STALL_S", 2.0)},
        {"name": "recompile_storm", "expected": ["recompile-storm"],
         "expected_gate": "fail",
         "overrides": ("FAULTS.ENABLED", "True",
                       "FAULTS.RECOMPILE_AT_BATCH", recompile_at,
                       "FAULTS.RECOMPILE_N", 12)},
        {"name": "slowdown", "expected": ["throughput-regression"],
         "expected_gate": "fail",
         "overrides": ("FAULTS.ENABLED", "True", "FAULTS.SLOWDOWN_EPOCH", 0,
                       "FAULTS.SLOWDOWN_MS", 250.0)},
    ]


def build_rules(*, baseline: float | None = None,
                p99_ms: float | None = None) -> list[AlertRule]:
    """The soak's rule set: the kinds config/monitor_rules.yaml ships,
    with the host-dependent thresholds filled by calibration (throughput
    baseline from the control interval, p99 from observed contended
    background latency). Dormant rules stay DECLARED so a false positive
    from them would still fail the exact-match check."""
    specs = [
        {"kind": "recompile-storm", "threshold": 8, "window_s": 10},
        {"kind": "stall", "threshold": 1},
        {"kind": "nonfinite", "threshold": 1},
        {"kind": "straggler-skew", "threshold": 1.5, "breach_windows": 2,
         "min_steps": 8},
        # breach_windows 3: a one-off pause (the recompile-storm burst, a
        # single stall) can dip at most two consecutive windows; only a
        # SUSTAINED regression breaches three
        {"kind": "throughput-regression", "threshold": 40.0,
         "breach_windows": 3, "min_steps": 4,
         **({"baseline": baseline} if baseline else {})},
    ]
    if p99_ms is not None:
        specs.append({"kind": "p99-breach", "threshold": p99_ms,
                      "breach_windows": 2, "min_steps": 4})
    return [AlertRule(s) for s in specs]


# ------------------------------------------------------------- train side
def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def spawn_train(work: str, out_dir: str, shards_root: str,
                overrides=(), tag: str = "run", opts=()):
    """One fresh-interpreter training run (non-blocking); returns
    (Popen, log_path)."""
    os.makedirs(work, exist_ok=True)
    script = os.path.join(work, "soak_worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    log_path = os.path.join(work, f"{tag}.log")
    data_over = ("TRAIN.DATASET", shards_root, "TEST.DATASET", shards_root)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, script, out_dir,
         *map(str, data_over + tuple(opts) + tuple(overrides))],
        env=_env(), cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT, text=True,
    )
    log.close()  # the child holds the fd
    return proc, log_path


def newest_checkpoint(out_dir: str) -> str | None:
    d = os.path.join(out_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    cands = sorted(
        n for n in os.listdir(d)
        if n.startswith("ckpt_ep_") and n.endswith(".pth")
    )
    return os.path.join(d, cands[-1]) if cands else None


def run_launches(log_path: str) -> dict:
    """The kernel launches a training interval's worker printed."""
    import ast

    try:
        text = open(log_path).read()
    except OSError:
        return {}
    marks = [ln for ln in text.splitlines() if ln.startswith("SOAK_RUN_DONE")]
    if not marks or "launches=" not in marks[-1]:
        return {}
    return ast.literal_eval(marks[-1].split("launches=", 1)[1])


def start_divergence(work: str, shards_root: str, opts=()):
    """Start the unmonitored rerun of the control config (its time is read
    by nothing, so it may overlap the serve plane's reload and shutdown);
    ``check_divergence`` compares it."""
    return spawn_train(work, os.path.join(work, "unmonitored"), shards_root,
                       tag="unmonitored", opts=opts)


def check_divergence(work: str, shards_root: str, monitored_out: str,
                     opts=(), started=None) -> dict:
    """Re-run the control config WITHOUT a monitor attached (or join the
    rerun ``start_divergence`` began) and compare the final checkpoints bit
    for bit in a fresh interpreter."""
    out2 = os.path.join(work, "unmonitored")
    proc, log_path = started or start_divergence(work, shards_root, opts)
    proc.wait(timeout=1800)
    a, b = newest_checkpoint(monitored_out), newest_checkpoint(out2)
    result = {"checked": True, "bit_identical": False,
              "monitored_ckpt": a, "unmonitored_ckpt": b,
              "launches": run_launches(log_path)}
    if proc.returncode != 0 or a is None or b is None:
        result["error"] = f"unmonitored rerun rc={proc.returncode}"
        return result
    script = os.path.join(work, "soak_compare.py")
    with open(script, "w") as f:
        f.write(COMPARE)
    cmp = subprocess.run(
        [sys.executable, script, a, b], env=_env(), cwd=_ROOT,
        capture_output=True, text=True, timeout=600,
    )
    result["bit_identical"] = cmp.returncode == 0
    lines = (cmp.stdout + cmp.stderr).strip().splitlines()
    marker = [ln for ln in lines if ln.startswith("COMPARE ")]
    result["detail"] = marker[-1] if marker else "\n".join(lines)[-200:]
    return result


# ------------------------------------------------------------- serve side
class ServePlane:
    """The co-located serving side: a FleetService (replicas are real
    ``serve_net`` processes), a router listener the monitor probes over
    the stats control frame, a Poisson background client, checkpoint
    hot-reload, and the overload burst."""

    def __init__(self, work: str, weights: str, *, rate_rps: float = 2.0,
                 opts=()):
        import io

        import numpy as np

        import distribuuuu_tpu_torch.config as config
        from distribuuuu_tpu_torch.config import cfg
        from distribuuuu_tpu_torch.serve.fleet import FleetService

        self.work = work
        self.rate_rps = float(rate_rps)
        config.reset_cfg()
        cfg.MODEL.ARCH = "resnet18"
        cfg.MODEL.NUM_CLASSES = 4
        cfg.MODEL.BN_GROUP = 8
        cfg.MODEL.WEIGHTS = weights
        cfg.DEVICE.COMPUTE_DTYPE = "float32"
        cfg.TRAIN.IM_SIZE = 16
        cfg.TEST.IM_SIZE = 16
        cfg.RNG_SEED = 0
        cfg.DATA.DEVICE_NORMALIZE = False  # float payloads, no PIL
        # cuDNN's heuristics: an autotune of the buckets would cost the
        # soak seconds at each start and hot-reload
        cfg.CUDNN.BENCHMARK = False
        cfg.OUT_DIR = os.path.join(work, "serve_out")
        cfg.SERVE.MAX_BATCH = 4
        cfg.SERVE.MAX_WAIT_MS = 5.0
        cfg.SERVE.MAX_QUEUE = 64
        cfg.SERVE.FLEET.AUTOSCALE = False  # the soak pins fleet size 1
        cfg.SERVE.FLEET.MIN_REPLICAS = 1
        cfg.SERVE.FLEET.HEALTH_PERIOD_S = 0.5
        cfg.merge_from_list(list(opts))
        self.cfg = cfg.clone()
        self.cfg_path = os.path.join(work, "serve_cfg.yaml")
        self._dump_cfg()

        rng = np.random.default_rng(0)
        self.payloads = []
        for _ in range(8):
            buf = io.BytesIO()
            np.save(buf, rng.standard_normal((16, 16, 3)).astype(np.float32))
            self.payloads.append(buf.getvalue())

        self.svc = FleetService(self.cfg, 1, cfg_path=self.cfg_path,
                                out_dir=work)
        self.tallies = {"ok": 0, "failed": 0, "backoff": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = None
        self.addr = None
        self.reloads: list[dict] = []

    def _dump_cfg(self) -> None:
        with open(self.cfg_path, "w") as f:
            f.write(self.cfg.dump())

    def start(self) -> "ServePlane":
        from distribuuuu_tpu_torch.serve import protocol

        self.svc.start(wait=True)
        self._listener = protocol.open_listener("127.0.0.1", 0)
        self.addr = self._listener.getsockname()[:2]
        threading.Thread(
            target=self.svc.serve,
            args=(self._listener, self._stop.is_set),
            daemon=True, name="soak-router",
        ).start()
        threading.Thread(
            target=self._background_client, daemon=True, name="soak-loadgen"
        ).start()
        return self

    def _dispatch(self, payload: bytes) -> str:
        """One request through the router; "ok" / "backoff" / "failed".
        Backpressure (queue_full / draining / no_routable_replicas) is the
        admission contract working: the caller backs off and retries the
        idempotent request; only a hard error counts failed."""
        resp = self.svc.router.dispatch(payload)
        if resp.startswith(b'{"error"'):
            err = json.loads(resp).get("error")
            if err in ("queue_full", "draining", "no_routable_replicas"):
                with self._lock:
                    self.tallies["backoff"] += 1
                return "backoff"
            with self._lock:
                self.tallies["failed"] += 1
            return "failed"
        with self._lock:
            self.tallies["ok"] += 1
        return "ok"

    def _background_client(self) -> None:
        """Poisson arrivals at ``rate_rps`` for the whole soak: the traffic
        that must survive every train interval and every hot-reload with
        zero failures."""
        import random

        i = 0
        while not self._stop.is_set():
            time.sleep(random.expovariate(self.rate_rps))
            if self._stop.is_set():
                break
            self._dispatch(self.payloads[i % len(self.payloads)])
            i += 1

    def observed_p99_ms(self, window_s: float = 30.0) -> float:
        return float(
            self.svc.router.window_stats(window_s).get("p99_ms", 0.0)
        )

    def hot_reload(self, ckpt_path: str) -> dict:
        """Roll the fleet onto a new checkpoint with zero dropped requests:
        rewrite the replica config's MODEL.WEIGHTS, then draining-restart
        every replica (mark_draining → SIGTERM drain → replacement spawn,
        warm-up gated). Records whether the served function actually
        changed (a fixed probe's logits differ)."""
        before = self._probe_logits()
        failed_before = self.tallies["failed"]
        self.cfg.defrost()
        self.cfg.MODEL.WEIGHTS = ckpt_path
        self._dump_cfg()
        ok = all(
            self.svc.pool.restart_replica(rep.id, wait=True)
            for rep in list(self.svc.router.replicas())
        )
        after = self._probe_logits()
        rec = {
            "ckpt": ckpt_path,
            "ok": bool(ok and self.svc.router.n_routable() >= 1),
            "failed_during_reload": self.tallies["failed"] - failed_before,
            "logits_changed": (
                before is not None and after is not None and before != after
            ),
        }
        self.reloads.append(rec)
        return rec

    def _probe_logits(self):
        resp = self.svc.router.dispatch(self.payloads[0])
        if resp.startswith(b'{"error"'):
            return None
        return json.loads(resp).get("logits")

    def measure_capacity_rps(self, seconds: float = 3.0,
                             clients: int = 4) -> float:
        """Short closed-loop probe of fleet capacity (the burst offers a
        multiple of this)."""
        done = {"n": 0}
        stop = time.perf_counter() + seconds

        def worker(ci):
            i = ci
            while time.perf_counter() < stop:
                self._dispatch(self.payloads[i % len(self.payloads)])
                done["n"] += 1
                i += 1

        threads = [threading.Thread(target=worker, args=(c,), daemon=True)
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return max(1.0, done["n"] / seconds)

    def overload_burst(self, clients: int, duration_s: float) -> dict:
        """Deeply oversubscribed closed-loop hammer: ``clients`` threads
        each keep one request outstanding, so admitted requests queue
        behind dozens of peers and latency climbs well past steady state
        (the p99-breach injection). queue_full rejections are expected and
        counted (the backpressure design working, not a failure)."""
        stop_at = time.perf_counter() + duration_s
        sent = {"n": 0}
        lock = threading.Lock()

        def worker(ci):
            i = ci
            while time.perf_counter() < stop_at:
                res = self._dispatch(self.payloads[i % len(self.payloads)])
                with lock:
                    sent["n"] += 1
                if res != "ok":
                    time.sleep(0.02)  # back off, keep the pressure on
                i += 1

        threads = [threading.Thread(target=worker, args=(c,), daemon=True)
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"clients": clients, "sent": sent["n"],
                "duration_s": duration_s}

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self.svc.shutdown()
        finally:
            if self._listener is not None:
                try:
                    self._listener.close()
                except OSError:
                    pass


# ----------------------------------------------------------------- referee
def _median(vals: list[float]) -> float | None:
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else None


def run_train_interval(spec: dict, *, work: str, shards_root: str,
                       rules: list[AlertRule], interval_s: float,
                       serve_addr, log, opts=()) -> dict:
    """One train interval: spawn the worker, monitor it live until exit,
    return {raised, snapshots, report, out_dir, rc}."""
    out_dir = os.path.join(work, "intervals", spec["name"])
    engine = RuleEngine(rules, interval_s=interval_s)
    mon = Monitor(out_dir, engine, serve_addr=serve_addr,
                  sink_path=os.path.join(work, f"MONITOR_{spec['name']}.jsonl"))
    proc, log_path = spawn_train(
        os.path.join(work, "intervals"), out_dir, shards_root,
        overrides=spec["overrides"], tag=spec["name"], opts=opts,
    )
    rates: list[float] = []

    def on_tick(out):
        snap = out["snapshot"]
        if snap["img_per_sec"] is not None and snap["steps"] >= 4:
            rates.append(snap["img_per_sec"])
        for a in out["alerts"]:
            log(f"    ALERT {a['rule']}: {a['message']}")

    t0 = time.time()
    mon.run(interval_s, should_stop=lambda: proc.poll() is not None,
            on_tick=on_tick)
    proc.wait(timeout=60)
    mon.close()
    return {
        "out_dir": out_dir, "rc": proc.returncode,
        "raised": sorted({a["rule"] for a in mon.alerts}),
        "alerts": mon.alerts, "median_img_per_sec": _median(rates),
        "duration_s": round(time.time() - t0, 1),
        "monitor_sink": mon.sink.path, "log": log_path,
        "launches": run_launches(log_path),
    }


def run_soak(args) -> dict:
    from distribuuuu_tpu_torch.telemetry import report as run_report

    log = lambda msg: print(msg, flush=True)  # noqa: E731
    work = args.work_dir or tempfile.mkdtemp(prefix="soak_")
    os.makedirs(work, exist_ok=True)
    opts = tuple(args.opts)
    sink = MonitorSink(os.path.join(work, "soak_events.jsonl"))
    # per-metric gate tolerances: tail percentiles and IO-shaped metrics
    # are high-variance on short intervals sharing the host with the
    # monitor and the serve plane; p50 and throughput stay at the strict
    # default: they are what the regression injections must move
    gate_tols = {"data_wait_frac": 400.0, "straggler_skew": 25.0,
                 "ckpt_save_max_s": 300.0, "step_ms_p90": 120.0,
                 "step_ms_p99": 250.0}

    log(f"soak: work dir {work}")
    shards_root, n_batches = make_corpus(work, args.per_class)
    log(f"soak: shard corpus ready ({args.per_class * 4} train samples, "
        f"{n_batches} batches/epoch)")
    matrix = interval_matrix(n_batches)
    if args.intervals:
        keep = set(args.intervals.split(","))
        matrix = [m for m in matrix if m["name"] in keep]
    if args.smoke:
        matrix = matrix[:2]  # control + nonfinite
    if not matrix or matrix[0]["name"] != "control":
        raise SystemExit("soak: the interval matrix must start with "
                         "'control' (it is the gate baseline)")

    serve: ServePlane | None = None
    rerun = None  # the unmonitored control rerun, once started
    intervals: list[dict] = []
    launches: dict[str, int] = {}
    control_report = None
    baseline_rate = None
    p99_threshold = None
    ok_all = True

    def add_launches(got: dict) -> None:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + int(v)

    try:
        for idx, spec in enumerate(matrix):
            # p99 rule arms once contended background latency is known
            # (observed while a train interval ran with traffic flowing)
            rules = build_rules(baseline=baseline_rate,
                                p99_ms=p99_threshold)
            armed = sorted(r.kind for r in rules
                           if not (r.kind == "throughput-regression"
                                   and r.baseline is None))
            log(f"[{idx}] {spec['name']}: rules armed: {', '.join(armed)}")
            res = run_train_interval(
                spec, work=work, shards_root=shards_root,
                rules=rules, interval_s=args.interval_s,
                serve_addr=serve.addr if serve else None, log=log, opts=opts,
            )
            add_launches(res["launches"])
            raised, expected = res["raised"], sorted(spec["expected"])
            entry = {
                "interval": idx, "name": spec["name"],
                "kind": "train", "rc": res["rc"],
                "expected_alerts": expected, "raised_alerts": raised,
                "alerts_exact": raised == expected,
                "duration_s": res["duration_s"],
                "median_img_per_sec": res["median_img_per_sec"],
                "launches": res["launches"],
            }
            # the per-interval report gate, evaluated NOW: control is the
            # baseline; regression-injecting intervals are expected to
            # FAIL it
            rep = run_report.build_report(res["out_dir"])
            if spec["name"] == "control":
                control_report = rep
                baseline_rate = res["median_img_per_sec"]
                entry["gate"] = None
            else:
                cmp = run_report.compare(rep, control_report,
                                         args.gate_tol_pct, gate_tols)
                want_fail = spec["expected_gate"] == "fail"
                entry["gate"] = {
                    "ok": cmp["ok"], "checked": cmp["checked"],
                    "expected": spec["expected_gate"],
                    "as_expected": cmp["ok"] != want_fail,
                    "failed_metrics": [r["metric"] for r in cmp["rows"]
                                       if not r["ok"]],
                    "rows": cmp["rows"],
                }
            entry["ok"] = (
                res["rc"] == 0 and entry["alerts_exact"]
                and (entry["gate"] is None or entry["gate"]["as_expected"])
            )
            ok_all &= entry["ok"]
            log(f"[{idx}] {spec['name']}: "
                f"{'ok' if entry['ok'] else 'FAIL'} — raised "
                f"{raised or '[]'} (expected {expected or '[]'})"
                + (f", gate {'PASS' if entry['gate']['ok'] else 'FAIL'} "
                   f"(expected {spec['expected_gate']})"
                   if entry["gate"] else ""))
            sink.emit_event("soak.interval", **{
                k: v for k, v in entry.items() if k != "kind"
            })
            intervals.append(entry)
            if (idx == len(matrix) - 1 and not args.no_divergence
                    and (serve is None or args.smoke)):
                # no training interval and no burst follow: the rerun
                # overlaps the last reload and the serve plane's shutdown
                log("soak: divergence check — re-running control unmonitored...")
                rerun = start_divergence(work, shards_root, opts)

            if spec["name"] == "control" and not args.no_serve:
                ckpt = newest_checkpoint(res["out_dir"])
                log(f"soak: starting serve fleet on {ckpt}")
                serve = ServePlane(work, ckpt, rate_rps=args.rate_rps,
                                   opts=opts)
                serve.start()
                log(f"soak: fleet routable, router stats at "
                    f"{serve.addr[0]}:{serve.addr[1]}, background "
                    f"Poisson at {args.rate_rps} rps")
            elif serve is not None:
                # contended-background p99 calibration after the first
                # train interval that ran WITH traffic flowing
                if p99_threshold is None:
                    obs = serve.observed_p99_ms(window_s=res["duration_s"])
                    # 4x the worst contended background p99, floored (an
                    # idle fleet's p99 is single-digit ms: 4x that is not
                    # a meaningful SLO) and capped (the burst must remain
                    # provably above the threshold)
                    p99_threshold = round(
                        min(max(4.0 * obs, 150.0), 600.0), 1
                    )
                    log(f"soak: p99-breach armed at {p99_threshold}ms "
                        f"(4x contended background p99 {obs}ms)")
                ckpt = newest_checkpoint(res["out_dir"])
                if ckpt:
                    rec = serve.hot_reload(ckpt)
                    log(f"soak: hot-reload -> {os.path.basename(ckpt)} "
                        f"ok={rec['ok']} failed={rec['failed_during_reload']}"
                        f" logits_changed={rec['logits_changed']}")

        # ---- the serve-plane burst interval (p99-breach) ----------------
        if serve is not None and p99_threshold is not None and not args.smoke:
            idx = len(intervals)
            cap = serve.measure_capacity_rps()
            burst_clients = 96
            log(f"[{idx}] p99_burst: fleet capacity ~{cap:.0f} rps; "
                f"hammering with {burst_clients} closed-loop clients")
            burst_dir = os.path.join(work, "intervals", "p99_burst")
            os.makedirs(burst_dir, exist_ok=True)
            engine = RuleEngine(build_rules(baseline=None,
                                            p99_ms=p99_threshold),
                                interval_s=args.interval_s)
            mon = Monitor(burst_dir, engine, serve_addr=serve.addr,
                          sink_path=os.path.join(work,
                                                 "MONITOR_p99_burst.jsonl"))
            burst_s = max(6 * args.interval_s, 12.0)
            burster = threading.Thread(
                target=serve.overload_burst, args=(burst_clients, burst_s),
                daemon=True,
            )
            t0 = time.time()
            burster.start()
            mon.run(args.interval_s,
                    should_stop=lambda: not burster.is_alive())
            burster.join()
            mon.close()
            raised = sorted({a["rule"] for a in mon.alerts})
            entry = {
                "interval": idx, "name": "p99_burst", "kind": "serve",
                "rc": 0, "expected_alerts": ["p99-breach"],
                "raised_alerts": raised,
                "alerts_exact": raised == ["p99-breach"],
                "duration_s": round(time.time() - t0, 1),
                "p99_threshold_ms": p99_threshold,
                "gate": None, "ok": raised == ["p99-breach"],
            }
            ok_all &= entry["ok"]
            log(f"[{idx}] p99_burst: {'ok' if entry['ok'] else 'FAIL'} — "
                f"raised {raised or '[]'}")
            sink.emit_event("soak.interval", **{
                k: v for k, v in entry.items() if k != "kind"
            })
            intervals.append(entry)
    finally:
        serve_summary = None
        if serve is not None:
            serve_summary = {
                "background_rate_rps": args.rate_rps,
                "requests_ok": serve.tallies["ok"],
                "requests_failed": serve.tallies["failed"],
                "backpressure_backoffs": serve.tallies["backoff"],
                "hot_reloads": serve.reloads,
                "p99_threshold_ms": p99_threshold,
            }
            serve.shutdown()

    # ---- trajectory divergence: monitored control vs unmonitored rerun --
    divergence = {"checked": False}
    if not args.no_divergence:
        if rerun is None:
            log("soak: divergence check — re-running control unmonitored...")
        divergence = check_divergence(
            work, shards_root, os.path.join(work, "intervals", "control"),
            opts=opts, started=rerun,
        )
        add_launches(divergence.get("launches", {}))
        log(f"soak: divergence checked — bit_identical="
            f"{divergence.get('bit_identical')}")
        ok_all &= bool(divergence.get("bit_identical"))
    if serve_summary is not None:
        ok_all &= serve_summary["requests_failed"] == 0
        ok_all &= all(r["ok"] and r["failed_during_reload"] == 0
                      for r in serve_summary["hot_reloads"])

    control = next((i for i in intervals if i["name"] == "control"), None)
    verdict = {
        "schema": SOAK_SCHEMA,
        "generated_by": "python -m distribuuuu_tpu_torch.soak",
        "platform": _platform(opts),
        "cpu_count": os.cpu_count(),
        "interval_s": args.interval_s,
        "train_batches_per_interval": n_batches,
        "intervals": intervals,
        "alerts_exact": all(i["alerts_exact"] for i in intervals),
        "control_clean": bool(control and not control["raised_alerts"]),
        "gates_evaluated": all(
            i["gate"] is not None and i["gate"]["checked"] > 0
            for i in intervals if i["name"] not in ("control", "p99_burst")
        ),
        "straggler_note": (
            "straggler-skew is not injectable on a lockstep DP run "
            "(collective wait equalizes every rank's measured step); the "
            "rule is held on synthetic multi-rank sinks in "
            "tests/test_torch_live.py"
        ),
        "serve": serve_summary,
        "divergence": divergence,
        "kernel_launches": launches,
        "work_dir": work,
        "ok": bool(ok_all),
    }
    sink.emit_event(
        "soak.verdict", ok=verdict["ok"],
        intervals=[i["name"] for i in intervals],
        alerts_exact=verdict["alerts_exact"],
        control_clean=verdict["control_clean"],
        gates_evaluated=verdict["gates_evaluated"],
    )
    sink.close()
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train+serve soak referee: fault-injected train "
                    "intervals + a serving fleet under Poisson traffic, "
                    "monitored live; emits a SOAK verdict JSON.",
    )
    ap.add_argument("--out", default="SOAK_r01.json")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--per-class", type=int, default=64,
                    help="train images per class (4 classes; batch 4 — "
                         "64 ⇒ 64 batches/interval)")
    ap.add_argument("--interval-s", type=float, default=2.5,
                    help="monitor evaluation interval (default 2.5s)")
    ap.add_argument("--rate-rps", type=float, default=2.0,
                    help="background Poisson request rate (default 2)")
    ap.add_argument("--gate-tol-pct", type=float, default=35.0,
                    help="per-interval regression-gate tolerance")
    ap.add_argument("--intervals", default=None,
                    help="comma-separated interval names to run "
                         "(control is always required first)")
    ap.add_argument("--smoke", action="store_true",
                    help="short referee: control + nonfinite, no serve "
                         "plane (unless --serve), no p99 burst")
    ap.add_argument("--serve", action="store_true",
                    help="with --smoke: keep the serve fleet (started after "
                         "control, hot-reloaded after nonfinite)")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the serve fleet / burst interval")
    ap.add_argument("--no-divergence", action="store_true",
                    help="skip the unmonitored-rerun bit-identity check")
    ap.add_argument("--dry", action="store_true",
                    help="validate the interval matrix, the soak rule "
                         "set, and config/monitor_rules.yaml; run nothing")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE overrides of every interval's and the "
                         "serve plane's config (DEVICE.PLATFORM cpu: no card)")
    args = ap.parse_args(argv)
    if len(args.opts) % 2:
        ap.error(f"KEY VALUE overrides come in pairs, got {args.opts}")
    if args.smoke:
        args.no_serve = args.no_serve or not args.serve
        args.per_class = min(args.per_class, 24)

    if args.dry:
        matrix = interval_matrix(args.per_class * 4 // 4)
        rules = build_rules(baseline=100.0, p99_ms=250.0)
        shipped = load_rules(os.path.join(_ROOT, "config",
                                          "monitor_rules.yaml"))
        for spec in matrix:  # overrides must be well-formed pairs
            if len(spec["overrides"]) % 2 != 0:
                raise SystemExit(
                    f"soak --dry: interval {spec['name']} has odd-length "
                    "overrides"
                )
            unknown = [a for a in spec["expected"]
                       if a not in {r.kind for r in rules}]
            if unknown:
                raise SystemExit(
                    f"soak --dry: interval {spec['name']} expects alerts "
                    f"no rule can raise: {unknown}"
                )
        print(f"soak --dry: {len(matrix)} intervals "
              f"({', '.join(s['name'] for s in matrix)} + p99_burst), "
              f"{len(rules)} soak rules, "
              f"{len(shipped)} shipped rules OK")
        return 0

    verdict = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(verdict, f, indent=1)
    print(f"soak verdict -> {args.out}: ok={verdict['ok']} "
          f"(alerts_exact={verdict['alerts_exact']}, "
          f"control_clean={verdict['control_clean']}, "
          f"gates_evaluated={verdict['gates_evaluated']}, "
          f"divergence={verdict['divergence']})")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
