"""The port's telemetry layer (distribuuuu_tpu_torch/telemetry/,
utils/jsonlog.py and the emission sites) against the JAX package's.

* The sink, the span stack, the registry, jsonlog and the schema: the
  port's counterparts of tests/test_telemetry.py and tests/test_jsonlog.py;
  every kind the port declares has the JAX package's required fields, and
  the JAX package's static pass finds no undeclared kind in the port.
* One toy resnet18 run (10 classes, 32², f64, four steps of 8 and an eval
  of 32 images) through the JAX ``train_model`` and the port's on the same
  weights and data: ``metrics.jsonl`` holds the same records in the same
  order, within the f64 locksteps' 1e-7; the rank files hold the same
  multiset of (kind, span name, track), apart from the kinds only one
  backend writes (:data:`BACKEND_KINDS`).
* ``tools/run_report.py``, unchanged, reads the port's run and writes its
  Perfetto trace; the port's exporter writes the JAX exporter's trace.
* Telemetry on and off train the same bits; ``test_model`` and
  ``serve_net`` leave their records; the ``PROF`` window writes a trace.
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys
import time

import jax
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, reset_port_cfg

import distribuuuu_tpu.config as jconfig
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.data import loader as jloader
from distribuuuu_tpu.data.dummy import DummyDataset as JaxDummy
from distribuuuu_tpu.telemetry import export as jexport
from distribuuuu_tpu.telemetry import registry as jregistry
from distribuuuu_tpu.telemetry import schema as jschema
from distribuuuu_tpu.telemetry import spans as jspans
from distribuuuu_tpu.utils import jsonlog as jjsonlog
from distribuuuu_tpu_torch import telemetry, trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.telemetry import export, runtime, schema, spans
from distribuuuu_tpu_torch.telemetry import registry as registry_lib
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import jsonlog
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "distribuuuu_tpu_torch")

# kinds one backend writes and the other cannot: the port's compile is a
# CUDA graph capture (none on the CPU) where JAX's CPU backend compiles;
# memstats and the graph's measured memory read the CUDA allocator (JAX's
# CPU backend has no memory stats; its cost.memory is XLA's static
# analysis of the compiled program)
BACKEND_KINDS = {"compile", "memstats", "cost.memory"}


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    yield from few_threads()
    spans.close_telemetry()
    jsonlog.close_metrics_log()
    registry_lib.get_registry().reset()
    runtime.uninstall_compile_listener()
    reset_port_cfg()


def _read(path):
    spans.flush()  # the writer thread's queue into the open sink
    return [json.loads(ln) for ln in open(path).read().splitlines()]


# ---------------------------------------------------------------- the sink
def test_noop_before_setup():
    spans.emit_event("stall", age_s=1.0, count=1)
    spans.emit_span("step", 0.0, 1.0)
    with spans.span("anything"):
        pass
    assert not spans.enabled()


def test_sink_opens_with_clock_anchor(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=3)
    assert os.path.basename(path) == "rank00003.jsonl"
    recs = _read(path)
    assert recs[0]["kind"] == "clock" and recs[0]["rank"] == 3
    off_now = time.time() - time.perf_counter()
    assert abs(off_now - (recs[0]["unix"] - recs[0]["mono"])) < 5.0


def test_a_sink_that_cannot_open_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        spans.setup_telemetry(str(blocker / "telemetry"))


def test_span_nesting_and_timestamps(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    with spans.span("outer", track="t"):
        time.sleep(0.01)
        with spans.span("inner", foo=7):
            time.sleep(0.01)
    recs = [r for r in _read(path) if r["kind"] == "span"]
    inner = next(r for r in recs if r["name"] == "inner")
    outer = next(r for r in recs if r["name"] == "outer")
    assert inner["parent"] == "outer" and inner["depth"] == 1 and inner["track"] == "t"
    assert "depth" not in outer and inner["foo"] == 7
    assert outer["t0"] <= inner["t0"]
    assert inner["t0"] + inner["dur"] <= outer["t0"] + outer["dur"] + 1e-6
    assert outer["dur"] >= 0.02 - 1e-3
    for r in recs:
        schema.validate_record(r)


def test_span_stacks_are_per_thread(tmp_path):
    """A span open on one thread is no parent of another thread's."""
    import threading

    path = spans.setup_telemetry(str(tmp_path), rank=0)
    with spans.span("main_outer", track="main"):
        def worker():
            with spans.span("worker_span", track="w"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    rec = next(r for r in _read(path) if r.get("name") == "worker_span")
    assert "parent" not in rec and rec["track"] == "w"


def test_emit_span_precomputed_stamps(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    spans.emit_span("step", 10.0, 10.5, track="pipeline", phase="train", epoch=1, batch=4,
                    n=32)
    (rec,) = [r for r in _read(path) if r["kind"] == "span"]
    assert rec["t0"] == 10.0 and rec["dur"] == 0.5
    assert rec["track"] == "pipeline" and rec["batch"] == 4
    schema.validate_record(rec)


def test_jsonlog_mirrors_rank_local_kinds_on_non_primary(tmp_path):
    jsonlog.setup_metrics_log(str(tmp_path), primary=False)
    path = spans.setup_telemetry(str(tmp_path / "telemetry"), rank=2)
    jsonlog.metrics_log("stall", age_s=12.5, last="epoch 1 batch 7", count=1)
    jsonlog.metrics_log("data_error", index=9, attempts=3, error="IOError: x")
    assert not os.path.exists(tmp_path / "metrics.jsonl")
    recs = _read(path)
    assert {"stall", "data_error"} <= {r["kind"] for r in recs}
    stall = next(r for r in recs if r["kind"] == "stall")
    assert stall["rank"] == 2 and stall["age_s"] == 12.5
    for r in recs:
        schema.validate_record(r)


def test_timeline_not_mirrored(tmp_path):
    jsonlog.setup_metrics_log(str(tmp_path), primary=True)
    path = spans.setup_telemetry(str(tmp_path / "telemetry"), rank=0)
    jsonlog.timeline_log("train", 1, 0, 16, get0=1.0, get1=1.1, bogus=3.0)
    (rec,) = _read(tmp_path / "metrics.jsonl")
    assert rec["kind"] == "timeline" and "bogus" not in rec and rec["get1"] == 1.1
    assert not any(r["kind"] == "timeline" for r in _read(path))


def test_emit_overhead_is_bounded(tmp_path):
    spans.setup_telemetry(str(tmp_path), rank=0)
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        spans.emit_span("step", 1.0, 1.1, track="pipeline", phase="train", epoch=1, batch=i,
                        n=8)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 500e-6, f"emit_span cost {per_call * 1e6:.0f}µs/call"


# ---------------------------------------------------------------- jsonlog
def test_jsonlog_records_are_one_json_per_line(tmp_path):
    jsonlog.metrics_log("train", loss=1.0)  # a no-op before setup
    jsonlog.setup_metrics_log(str(tmp_path))
    jsonlog.metrics_log("train", epoch=1, loss=2.5)
    jsonlog.metrics_log("eval", epoch=1, top1=10.0)
    jsonlog.close_metrics_log()
    recs = _read(tmp_path / "metrics.jsonl")
    assert [r["kind"] for r in recs] == ["train", "eval"]
    assert recs[0]["loss"] == 2.5 and recs[1]["top1"] == 10.0 and all("t" in r for r in recs)
    assert jsonlog.TIMELINE_STAGES == jjsonlog.TIMELINE_STAGES
    assert jsonlog.TIMELINE_SCHEMA == jjsonlog.TIMELINE_SCHEMA


def test_jsonlog_non_primary_is_silent(tmp_path):
    jsonlog.setup_metrics_log(str(tmp_path), primary=False)
    jsonlog.metrics_log("train", loss=1.0)
    assert not os.path.exists(tmp_path / "metrics.jsonl")


# --------------------------------------------------------------- registry
def test_registry_aggregation_matches_jax():
    port, ref = registry_lib.Registry(), jregistry.Registry()
    for reg in (port, ref):
        reg.counter("c").inc()
        reg.counter("c").inc(2.5)
        reg.gauge("g").set(1.0)
        reg.gauge("g").set(4.0)
        for v in range(1, 101):
            reg.histogram("h").observe(float(v))
    snap = port.snapshot()
    assert snap == ref.snapshot()
    hs = snap["histograms"]["h"]
    assert snap["counters"]["c"] == 3.5 and snap["gauges"]["g"] == 4.0
    assert (hs["count"], hs["min"], hs["max"]) == (100, 1.0, 100.0)
    assert (hs["p50"], hs["p90"], hs["p99"]) == (50.0, 90.0, 99.0)
    assert port.counter("x") is port.counter("x") and port.histogram("y") is port.histogram("y")


def test_reservoir_draws_from_its_own_generator():
    """Past its bound a histogram replaces samples, drawing from the
    registry's generator: Python's global ``random`` stream is not moved."""
    random.seed(123)
    want = random.random()
    random.seed(123)
    h = registry_lib.Registry().histogram("h", max_samples=8)
    for v in range(100):
        h.observe(float(v))
    assert random.random() == want
    assert h.count == 100 and len(h.values()) == 8


def test_registry_snapshot_lands_in_sink(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    registry_lib.get_registry().counter("jit.compiles").inc(4)
    telemetry.emit_snapshot(epoch=2)
    (rec,) = [r for r in _read(path) if r["kind"] == "registry"]
    assert rec["counters"]["jit.compiles"] == 4.0 and rec["epoch"] == 2
    schema.validate_record(rec)


def test_serve_metrics_ride_a_registry_and_match_jax():
    from distribuuuu_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
    from distribuuuu_tpu_torch.serve.metrics import ServeMetrics

    port, ref = ServeMetrics(), JaxServeMetrics()
    for m in (port, ref):
        m.record_batch(3, 4, 0.010, [0.001, 0.002, 0.003])
        m.record_rejection()
    a, b = port.snapshot(), ref.snapshot()
    for k in ("throughput_rps", "window_s"):  # the window's own clock
        a.pop(k), b.pop(k)
    assert a == b
    assert a["requests"] == 3 and a["rejected"] == 1 and a["p99_ms"] == 3.0
    assert port.registry.snapshot()["counters"]["serve.requests"] == 3.0


# ----------------------------------------------------------------- schema
def test_validate_record_rejects_undeclared_and_drifted():
    with pytest.raises(schema.SchemaError, match="undeclared"):
        schema.validate_record({"kind": "no_such_kind"})
    with pytest.raises(schema.SchemaError, match="missing required"):
        schema.validate_record({"kind": "stall", "age_s": 1.0})
    schema.validate_record({"kind": "stall", "age_s": 1.0, "count": 2})


@pytest.mark.parametrize("kind", sorted(schema.KINDS))
def test_every_port_kind_has_the_jax_fields(kind):
    assert kind in jschema.KINDS
    assert schema.KINDS[kind] == jschema.KINDS[kind]


def test_port_emission_sites_are_clean_under_the_jax_pass():
    """The JAX package's static pass over the port's package: every literal
    kind at an emission site is declared (in JAX's schema) with its
    required fields present; and every kind seen is one the port declares."""
    from distribuuuu_tpu.analysis.passes import telemetry as tpass

    findings, seen = tpass.check_tree(PORT_PKG)
    assert findings == []
    assert seen <= set(schema.KINDS), sorted(seen - set(schema.KINDS))
    assert {"train", "gen.decode", "kernel.select", "cost.step", "trace.span"} <= seen


def test_setup_from_cfg_honours_the_telemetry_node(tmp_path):
    tcfg.OUT_DIR = str(tmp_path)
    tcfg.TELEMETRY.ENABLED = False
    assert telemetry.setup_from_cfg(tcfg) is None and not spans.enabled()
    tcfg.TELEMETRY.ENABLED = True
    assert telemetry.setup_from_cfg(tcfg, rank=1) == str(tmp_path / "telemetry/rank00001.jsonl")
    tcfg.TELEMETRY.DIR = str(tmp_path / "elsewhere")
    assert telemetry.setup_from_cfg(tcfg).startswith(str(tmp_path / "elsewhere"))


# ---------------------------------------------------------------- runtime
def test_capture_and_build_hooks(tmp_path):
    runtime.on_capture(0.5)  # the sink closed: nothing counts
    assert registry_lib.get_registry().snapshot()["counters"] == {}
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    runtime.on_capture(0.5)  # not installed: nothing either
    runtime.install_compile_listener()
    runtime.on_capture(0.25)
    runtime.on_build("opt_update", hit=False)
    runtime.on_build("opt_update", hit=True)
    counters = registry_lib.get_registry().snapshot()["counters"]
    assert counters["jit.compiles"] == 1 and counters["jit.compile_s"] == 0.25
    assert counters["jit.cache_hits"] == 1 and counters["jit.cache_misses"] == 1
    recs = _read(path)
    (comp,) = [r for r in recs if r["kind"] == "compile"]
    assert comp["event"] == runtime.CAPTURE_EVENT and comp["dur_s"] == 0.25
    cache = [r for r in recs if r["kind"] == "compile.cache"]
    assert [r["event"] for r in cache] == ["miss", "hit"]
    assert cache[1]["hits"] - cache[0]["hits"] == 1
    assert runtime.sample_memstats(torch.device("cpu")) == 0  # no card, no record
    for r in recs:
        schema.validate_record(r)


def test_kernel_select_once_per_op_and_impl(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    kernel_tier._selected.clear()
    x = torch.zeros(2)
    for _ in range(3):
        assert kernel_tier.choose(x, "opt_update") is False
    with pytest.raises(RuntimeError, match="no kernel or plain version"):
        kernel_tier.choose(torch.empty(2, device="meta"), "conv_epilogue")
    with kernel_tier.counting():  # the ledger's count: meta takes the plain path, unrecorded
        assert kernel_tier.choose(torch.empty(2, device="meta"), "conv_epilogue") is False
    (rec,) = [r for r in _read(path) if r["kind"] == "kernel.select"]
    assert (rec["op"], rec["impl"], rec["requested"]) == ("opt_update", "plain", "auto")


# ----------------------------------------------------------------- export
def test_export_merges_ranks_like_the_jax_exporter(tmp_path):
    """Two rank files with their own clock anchors, timeline records and a
    request's trace spans from both: the port's merge equals JAX's."""
    os.makedirs(tmp_path / "telemetry")
    for rank, mono0 in ((0, 100.0), (1, 5000.0)):
        with open(tmp_path / "telemetry" / f"rank{rank:05d}.jsonl", "w") as f:
            recs = [{"kind": "clock", "rank": rank, "t": 1.0, "unix": 1000.0, "mono": mono0},
                    {"kind": "span", "rank": rank, "t": 1.0, "v": 1, "name": "step",
                     "t0": mono0 + 1.0, "dur": 0.5, "track": "pipeline", "phase": "train"},
                    {"kind": "compile", "rank": rank, "t": 1.0, "event": "cuda_graph_capture",
                     "dur_s": 0.2, "mono": mono0 + 0.5},
                    {"kind": "stall", "rank": rank, "t": 1001.0, "age_s": 3.0, "count": 1},
                    {"kind": "trace.span", "rank": rank, "t": 1.0, "v": 1, "trace": "aa",
                     "span": f"s{rank}", "parent": "" if rank == 0 else "s0",
                     "name": "engine.request", "t0": mono0 + 2.0, "dur": 0.1}]
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    with open(tmp_path / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"t": 1.0, "kind": "timeline", "v": 1, "phase": "train", "epoch": 1,
                            "batch": 0, "n": 8, "dec0": 101.0, "dec1": 101.1, "asm1": 101.2,
                            "get0": 101.0, "get1": 101.3, "put0": 101.3, "put1": 101.4,
                            "step0": 101.4, "step1": 101.9}) + "\n")
    ours, ref = export.merge_trace(str(tmp_path)), jexport.merge_trace(str(tmp_path))
    ours["otherData"].pop("source"), ref["otherData"].pop("source")
    assert ours == ref
    steps = [e for e in ours["traceEvents"] if e.get("name") == "step" and e.get("cat") == "span"]
    assert sorted(e["ts"] for e in steps) == [1001.0e6, 1001.0e6]  # anchors align the ranks
    path = export.export_trace(str(tmp_path))
    assert json.load(open(path))["traceEvents"]


# ------------------------------------------------- runs against the reference
def _toy(cfg, out_dir, dtype="float64"):
    cfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", dtype, "TRAIN.IM_SIZE", 32,
        "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 0, "OPTIM.MAX_EPOCH", 1,
        "OPTIM.BASE_LR", 0.05, "MODEL.BN_GROUP", 8, "OUT_DIR", str(out_dir),
    ])


def _fresh_jax_telemetry():
    """The JAX package's process-wide telemetry state as a new process has
    it (its ledger counts a label and its kernel tier records a choice
    once a process): before the JAX run, so it writes every record, and
    after, so the JAX tests that follow in this process do too."""
    from distribuuuu_tpu.ops import pallas
    from distribuuuu_tpu.telemetry import costmodel as jcost

    jspans.close_telemetry()
    jjsonlog.close_metrics_log()
    jregistry.get_registry().reset()
    jcost.reset()
    pallas._emitted.clear()


def _kinds(recs):
    return collections.Counter((r["kind"], r.get("name"), r.get("track")) for r in recs
                               if r["kind"] not in BACKEND_KINDS)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The toy run through the JAX trainer (8 virtual devices, 1 image a
    device: a global batch of 8) and the port's (a batch of 8), both at
    f64 from the JAX run's initial weights, on 32 dummy images a split."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("telemetry_runs")
    jax.config.update("jax_enable_x64", True)
    init = {}
    make_state = jtrainer.create_train_state

    def capture(*a, **k):
        state = make_state(*a, **k)
        init["params"] = jax.tree.map(np.array, jax.device_get(state.params))
        init["batch_stats"] = jax.tree.map(np.array, jax.device_get(state.batch_stats))
        return state

    _fresh_jax_telemetry()
    try:
        mp.setattr(jtrainer, "create_train_state", capture)
        mp.setattr(jloader, "_build_dataset",
                   lambda split, train: JaxDummy(length=32, size=32, raw_u8=True))
        jconfig.reset_cfg()
        _toy(jcfg, root / "jax")
        jcfg.merge_from_list(["TRAIN.BATCH_SIZE", 1, "TEST.BATCH_SIZE", 2])
        jtrainer.train_model()
    finally:
        _fresh_jax_telemetry()
        jconfig.reset_cfg()
        jax.config.update("jax_enable_x64", False)

    build = trainer.build_model_from_cfg

    def from_jax(generator=None):
        model = build(generator)
        model.load_state_dict(state_dict_from_jax(init["params"], init["batch_stats"]))
        return model

    try:
        mp.setattr(trainer, "build_model_from_cfg", from_jax)
        mp.setattr(tloader, "_build_dataset", lambda train: DummyDataset(32, 32, raw_u8=True))
        reset_port_cfg()
        _toy(tcfg, root / "port")
        tcfg.merge_from_list(["TRAIN.BATCH_SIZE", 8, "TEST.BATCH_SIZE", 16])
        with torch.random.fork_rng():
            torch.set_num_threads(2)
            trainer.train_model()
    finally:
        mp.undo()
        reset_port_cfg()
    return root / "jax", root / "port"


def test_metrics_records_match_the_jax_run(reference_runs):
    jdir, pdir = reference_runs
    keyed = {}
    for name, d in (("jax", jdir), ("port", pdir)):
        recs = [r for r in _read(d / "metrics.jsonl") if r["kind"] != "timeline"]
        keyed[name] = [(r["kind"], r["epoch"], r.get("batch")) for r in recs], recs
    assert keyed["jax"][0] == keyed["port"][0] == [
        ("train", 1, 2), ("train", 1, 4), ("eval", 1, None), ("epoch", 1, None)]
    for j, p in zip(keyed["jax"][1], keyed["port"][1]):
        schema.validate_record(p)
        for k in ("loss", "top1", "topk", "acc1", "best_acc1", "samples", "lr"):
            if k in j:
                assert p[k] == pytest.approx(j[k], rel=1e-7, abs=1e-7), (j["kind"], k)
    timelines = {name: [(r["phase"], r["batch"], r["n"]) for r in _read(d / "metrics.jsonl")
                        if r["kind"] == "timeline"] for name, d in (("jax", jdir), ("port", pdir))}
    assert timelines["jax"] == timelines["port"]
    for r in _read(pdir / "metrics.jsonl"):
        if r["kind"] == "timeline":
            assert set(jsonlog.TIMELINE_STAGES) <= set(r), r


def test_rank_files_match_the_jax_run(reference_runs):
    jdir, pdir = reference_runs
    jrecs = _read(jdir / "telemetry/rank00000.jsonl")
    precs = _read(pdir / "telemetry/rank00000.jsonl")
    for r in precs:
        schema.validate_record(r)
    assert _kinds(precs) == _kinds(jrecs)
    # the port's CPU run writes none of the card-only kinds
    assert not {r["kind"] for r in precs} & BACKEND_KINDS
    cost = {r["label"]: r for r in precs if r["kind"] == "cost.step"}
    assert set(cost) == {"train_step", "eval_step"}
    assert {r["source"] for r in cost.values()} == {"dispatch"}
    # resnet18 at 32²: the hand table's 2 × 1.82 GFLOP at 224², scaled by area
    fwd = 2 * 1.82e9 * (32 / 224) ** 2
    assert cost["eval_step"]["flops"] / 16 == pytest.approx(fwd, rel=0.1)
    assert cost["train_step"]["flops"] / 8 == pytest.approx(3 * fwd, rel=0.1)


def test_run_report_reads_the_port_run(reference_runs, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import run_report

    _, pdir = reference_runs
    rep = run_report.build_report(str(pdir))
    assert rep["step"]["count"] == 4 and rep["step_source"] == "step"
    assert rep["img_per_sec"] is not None and rep["img_per_sec"] > 0
    assert rep["cost"]["source"] == "dispatch" and rep["cost"]["flops_per_step"] > 0
    assert rep["checkpoint"]["saves"] == 1
    assert run_report.main(["--trace", str(pdir)]) in (0, None)
    trace = json.load(open(pdir / "trace.json"))
    names = {(e.get("name"), e.get("cat")) for e in trace["traceEvents"]}
    assert {("step", "span"), ("decode", "span"), ("step", "timeline")} <= names
    # the port's exporter writes the same trace
    ours = export.merge_trace(str(pdir))
    ref = jexport.merge_trace(str(pdir))
    ours["otherData"].pop("source"), ref["otherData"].pop("source")
    assert ours == ref


def _small_data(monkeypatch, n=16):
    monkeypatch.setattr(tloader, "_build_dataset",
                        lambda train: DummyDataset(n, tcfg.TRAIN.IM_SIZE, raw_u8=True))


def test_telemetry_on_and_off_train_the_same_bits(tmp_path, monkeypatch):
    _small_data(monkeypatch)
    payloads = {}
    for on in (True, False):
        reset_port_cfg()
        _toy(tcfg, tmp_path / str(on), dtype="float32")
        tcfg.merge_from_list(["TRAIN.BATCH_SIZE", 4, "TEST.BATCH_SIZE", 8,
                              "TELEMETRY.ENABLED", on, "MODEL.BN_GROUP", 0])
        torch.manual_seed(0)
        trainer.train_model()
        payloads[on] = ckpt.load_checkpoint(str(tmp_path / str(on) /
                                                "checkpoints/ckpt_ep_000.pth"))
    assert os.path.exists(tmp_path / "True/telemetry/rank00000.jsonl")
    assert not os.path.exists(tmp_path / "False/telemetry")
    a, b = payloads[True], payloads[False]
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["opt"]["m"]:
        assert torch.equal(a["opt"]["m"][k], b["opt"]["m"][k]), k


def test_fold_writes_fold_windows_and_the_profiler_window(tmp_path, monkeypatch):
    """``STEPS_PER_CALL 2``: one ``fold_window`` span a call and no
    per-batch timeline, as JAX; ``PROF`` over steps [1, 3) writes a Chrome
    trace that parses."""
    _small_data(monkeypatch)
    _toy(tcfg, tmp_path, dtype="float32")
    tcfg.merge_from_list(["TRAIN.BATCH_SIZE", 4, "TEST.BATCH_SIZE", 8, "MODEL.BN_GROUP", 0,
                          "TRAIN.STEPS_PER_CALL", 2, "PROF.ENABLED", True,
                          "PROF.START_STEP", 1, "PROF.NUM_STEPS", 2])
    trainer.train_model()
    recs = _read(tmp_path / "telemetry/rank00000.jsonl")
    folds = [r for r in recs if r.get("name") == "fold_window"]
    assert [(r["batch"], r["n"]) for r in folds] == [(0, 2), (2, 2)]
    assert not [r for r in recs if r.get("name") == "step" and r.get("phase") == "train"]
    timeline = [r for r in _read(tmp_path / "metrics.jsonl") if r["kind"] == "timeline"]
    assert {r["phase"] for r in timeline} == {"eval"}
    trace = json.load(open(tmp_path / "profile/trace_ep1.json"))
    assert trace["traceEvents"]


def test_test_model_and_serve_net_leave_their_records(tmp_path, monkeypatch):
    from distribuuuu_tpu_torch import serve_net
    from distribuuuu_tpu_torch.serve import engine as serve_engine

    _small_data(monkeypatch)
    _toy(tcfg, tmp_path / "eval", dtype="float32")
    tcfg.merge_from_list(["TEST.BATCH_SIZE", 8, "MODEL.BN_GROUP", 0])
    trainer.test_model()
    for sub in ("eval",):
        recs = _read(tmp_path / sub / "metrics.jsonl")
        assert [r["kind"] for r in recs if r["kind"] != "timeline"] == ["eval"]
        rank = _read(tmp_path / sub / "telemetry/rank00000.jsonl")
        assert {"clock", "cost.step", "registry", "eval"} <= {r["kind"] for r in rank}
    monkeypatch.setattr(serve_engine.Engine, "__init__", _fast_engine_init(
        serve_engine.Engine.__init__))
    images = np.zeros((3, 32, 32, 3), np.uint8)
    np.save(tmp_path / "in.npy", images)
    reset_port_cfg()
    serve_net.main(["--cfg", os.path.join(REPO, "config/resnet18.yaml"), "--batch-input",
                    str(tmp_path / "in.npy"), "--batch-output", str(tmp_path / "out.npy"),
                    "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                    "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32", "SERVE.MAX_BATCH", "2",
                    "OUT_DIR", str(tmp_path / "serve")])
    (serve,) = _read(tmp_path / "serve/metrics.jsonl")
    assert serve["kind"] == "serve" and serve["requests"] == 3 and serve["final"] is True
    rank = _read(tmp_path / "serve/telemetry/rank00000.jsonl")
    labels = {r["label"] for r in rank if r["kind"] == "cost.step"}
    assert labels == {"serve_bucket_1", "serve_bucket_2"}
    for r in rank:
        schema.validate_record(r)


def _fast_engine_init(init):
    def wrapped(self, *a, **k):
        k.setdefault("max_wait_ms", 1.0)
        return init(self, *a, **k)
    return wrapped


def test_resilience_and_loader_records(tmp_path):
    from distribuuuu_tpu_torch.resilience import supervisor

    path = spans.setup_telemetry(str(tmp_path), rank=1)
    mon = supervisor.NonFiniteMonitor("skip", 0)
    assert mon.observe(float("nan"), 1.0, 3) is True
    with pytest.raises(supervisor.NonFiniteLossError):
        supervisor.NonFiniteMonitor("raise", 0).observe(float("nan"), 1.0, 4)
    hb = supervisor.Heartbeat(0.05)
    time.sleep(0.4)
    hb.stop()
    recs = _read(path)
    nonfinite = [r for r in recs if r["kind"] == "nonfinite"]
    assert [(r["batch"], r["policy"]) for r in nonfinite] == [(3, "skip"), (4, "raise")]
    assert [r for r in recs if r["kind"] == "stall"][0]["count"] == 1
    counters = registry_lib.get_registry().snapshot()["counters"]
    assert counters["resilience.nonfinite"] == 2 and counters["resilience.stalls"] >= 1
    for r in recs:
        schema.validate_record(r)


def test_async_checkpoint_spans_and_record(tmp_path):
    tcfg.merge_from_list(["OUT_DIR", str(tmp_path), "CHECKPOINT.ASYNC", True])
    path = spans.setup_telemetry(str(tmp_path / "telemetry"), rank=0)
    state = {"model": {"w": torch.ones(3)}, "opt": {"count": 1}, "step": 1}
    ckpt.save_checkpoint(state, 0, 1.0, is_best=False)
    from distribuuuu_tpu_torch.asyncplane import committer

    committer.join_commits()
    ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    recs = _read(path)
    names = [r["name"] for r in recs if r["kind"] == "span"]
    assert names == ["ckpt_snapshot", "ckpt_commit", "ckpt_restore"]
    assert {r["track"] for r in recs if r["kind"] == "span"} == {"ckpt"}
    (rec,) = [r for r in recs if r["kind"] == "ckpt.async"]
    assert rec["ckpt"] == "ckpt_ep_000.pth" and rec["ok"] is True
    for r in recs:
        schema.validate_record(r)


def test_concurrent_emits_stay_whole_lines_in_order(tmp_path):
    """Many threads emitting at once through the one writer: every record
    lands whole, once, and each thread's records in its own order."""
    import threading

    path = spans.setup_telemetry(str(tmp_path), rank=0)
    n_threads, n = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            spans.emit_event("stall", age_s=float(i), count=k) for i in range(n)])
            for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans.close_telemetry()
    recs = [r for r in _read(path) if r["kind"] == "stall"]
    assert len(recs) == n_threads * n
    for k in range(n_threads):
        assert [r["age_s"] for r in recs if r["count"] == k] == [float(i) for i in range(n)]


class _Corrupt(DummyDataset):
    def __getitem__(self, i):
        if int(i) == 3:
            raise OSError("bad bytes")
        return super().__getitem__(i)


def test_loader_counts_batches_and_records_a_corrupt_sample(tmp_path):
    tcfg.merge_from_list(["DATA.SKIP_CORRUPT", True, "DATA.RETRIES", 1,
                          "DATA.RETRY_BACKOFF_S", 0.0, "TELEMETRY.STEP_SPANS", True])
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    loader = tloader.Loader(_Corrupt(8, 32, raw_u8=True), 4, shuffle=False, drop_last=False,
                            workers=1)
    stamps = []
    for batch in loader:
        assert batch["image"].shape[0] == 4
        stamps.append(loader.last_timing())
    assert all(s["submit"] <= s["dec0"] <= s["dec1"] <= s["asm1"] for s in stamps)
    recs = _read(path)
    (err,) = [r for r in recs if r["kind"] == "data_error"]
    assert err["index"] == 3 and err["attempts"] == 2 and "bad bytes" in err["error"]
    assert [r["name"] for r in recs if r["kind"] == "span"] == ["decode", "assemble"] * 2
    counters = registry_lib.get_registry().snapshot()["counters"]
    assert counters["data.batches"] == 2 and counters["data.samples"] == 8
    assert counters["data.errors"] == 1


def test_writer_serialises_numpy_fields_and_surfaces_a_failed_write(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    spans.emit_event("stall", age_s=np.float32(1.5), count=np.int64(2))
    (rec,) = [r for r in _read(path) if r["kind"] == "stall"]
    assert (rec["age_s"], rec["count"]) == (1.5, 2)
    os.close(spans._sink["f"].fileno())  # the file goes away under the writer
    spans.emit_event("stall", age_s=1.0, count=3)
    with pytest.raises((RuntimeError, OSError)):
        spans.flush()
        spans.close_telemetry()
    spans._sink.update(f=None, q=None, writer=None, error=None)
