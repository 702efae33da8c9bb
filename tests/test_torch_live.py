"""The port's live plane (distribuuuu_tpu_torch/telemetry/live.py and
telemetry/report.py) against the JAX package's: the tailer edge cases of
tests/test_monitor.py on the port's classes; the LiveAggregator, the
RuleEngine (all 12 rule kinds, on the same synthetic snapshot streams)
and render_prometheus held to JAX's outputs on the same records (the
same alert records, identical Prometheus text, floats within 1e-12);
``report.build_report`` equal to tools/run_report.py's on a port CPU toy
run, whose aggregated totals it also equals; the CLI's ``--dry`` and
``--once``; and a monitor attached to a toy run changes no bit of it."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch_port_util import few_threads, reset_port_cfg

from distribuuuu_tpu.telemetry import live as jlive
from distribuuuu_tpu.telemetry import schema as jschema
from distribuuuu_tpu_torch.telemetry import live, report, schema, spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import run_report  # noqa: E402  (tools/, needs the path insert above)

FLOAT_TOL = 1e-12
LIVE_KINDS = ("monitor.snapshot", "alert", "soak.interval", "soak.verdict",
              "campaign.phase", "campaign.verdict", "trace.exemplar")


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    yield
    spans.close_telemetry()
    reset_port_cfg()


def _same(a, b, path="") -> None:
    """Equal structure and values; floats within FLOAT_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), f"{path}: {a} != {b}"
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: {a} != {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= FLOAT_TOL, f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _jl(path, recs, mode="a"):
    with open(path, mode) as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _span(rank, name, t0, dur, **kw):
    return {"kind": "span", "rank": rank, "t": 0.0, "v": 1, "name": name,
            "t0": t0, "dur": dur, "track": "pipeline", "phase": "train",
            "epoch": 1, **kw}


def _rank_path(tmp_path, rank):
    tdir = tmp_path / "telemetry"
    tdir.mkdir(exist_ok=True)
    return str(tdir / f"rank{rank:05d}.jsonl")


def _write_rank(tmp_path, rank, step_ms, *, extra=None, anchor=1000.0):
    path = _rank_path(tmp_path, rank)
    recs = [{"kind": "clock", "rank": rank, "t": 0.0,
             "unix": 1_700_000_000.0, "mono": anchor}]
    for i, ms in enumerate(step_ms):
        t0 = anchor + i * 1.0
        recs.append(_span(rank, "step", t0, ms / 1e3, batch=i, n=8))
        recs.append(_span(rank, "wait", t0 - 0.05, 0.05, batch=i))
    for r in extra or []:
        recs.append({"rank": rank, "t": 0.0, **r})
    _jl(path, recs, mode="w")
    return path


# ------------------------------------------------------- tailer edge cases
def test_tailer_incremental_never_double_counts(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path, rank=0)
    assert t.poll() == []
    _jl(path, [{"kind": "stall", "age_s": 1.0, "count": i} for i in range(3)])
    assert len(t.poll()) == 3
    assert t.poll() == []
    _jl(path, [{"kind": "stall", "age_s": 1.0, "count": 3}])
    assert [r["count"] for r in t.poll()] == [3]
    assert t.lines == 4


def test_tailer_holds_partial_trailing_line(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path)
    with open(path, "w") as f:
        f.write('{"kind": "stall", "age_s": 1.0, "co')
    assert t.poll() == []
    with open(path, "a") as f:
        f.write('unt": 7}\n{"kind": "stall", "age')
    got = t.poll()
    assert len(got) == 1 and got[0]["count"] == 7
    with open(path, "a") as f:
        f.write('_s": 2.0, "count": 8}\n')
    got = t.poll()
    assert len(got) == 1 and got[0]["count"] == 8
    assert t.bad_lines == 0


def test_tailer_survives_truncation(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path)
    _jl(path, [{"kind": "stall", "age_s": 1.0, "count": i} for i in range(5)])
    assert len(t.poll()) == 5
    with open(path, "w") as f:
        f.write('{"kind": "stall", "age_s": 9.0, "count": 99}\n')
    assert [r["count"] for r in t.poll()] == [99]
    assert t.resets == 1


def test_tailer_survives_rotation(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path)
    _jl(path, [{"kind": "stall", "age_s": 1.0, "count": 1}])
    assert len(t.poll()) == 1
    side = str(tmp_path / "new.jsonl")
    _jl(side, [{"kind": "stall", "age_s": 2.0, "count": 2}], mode="w")
    os.replace(side, path)
    assert [r["count"] for r in t.poll()] == [2]
    assert t.resets == 1


def test_tailer_skips_bad_json_lines(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path)
    with open(path, "w") as f:
        f.write("not json at all\n")
        f.write('{"kind": "stall", "age_s": 1.0, "count": 1}\n')
    got = t.poll()
    assert len(got) == 1 and t.bad_lines == 1


def test_tailer_clock_anchor_reread(tmp_path):
    path = _rank_path(tmp_path, 0)
    t = live.FileTailer(path)
    _jl(path, [{"kind": "clock", "unix": 1000.0, "mono": 10.0}])
    t.poll()
    assert t.to_unix(11.0) == pytest.approx(1001.0)
    _jl(path, [{"kind": "clock", "unix": 5000.0, "mono": 0.0}])
    t.poll()
    assert t.to_unix(1.0) == pytest.approx(5001.0)


def test_run_tailer_picks_up_late_rank_sink(tmp_path):
    rt = live.RunTailer(str(tmp_path))
    assert rt.poll() == ([], [])
    _write_rank(tmp_path, 0, [100.0])
    recs, _ = rt.poll()
    assert {r["rank"] for r in recs if r["kind"] == "span"} == {0}
    _write_rank(tmp_path, 3, [100.0, 100.0])
    recs, _ = rt.poll()
    assert {r["rank"] for r in recs if r["kind"] == "span"} == {3}
    assert sum(1 for r in recs if r.get("name") == "step") == 2
    assert sorted(rt.tailers) == [0, 3]


# ------------------------------------------- the aggregator against JAX's
def _fixture_run(tmp_path):
    """Two ranks of step spans (rank 1 a straggler), a folded rank, every
    record kind the aggregator reads, and the primary's mirrored events;
    returned as two batches (the second appended after a first poll)."""
    first = {
        0: [{"kind": "clock", "t": 0.0, "unix": 1.7e9, "mono": 1000.0}]
        + [_span(0, "step", 1000.0 + i, 0.1 + 0.003 * i, batch=i, n=8) for i in range(10)]
        + [_span(0, "wait", 999.95 + i, 0.05, batch=i) for i in range(10)]
        + [{"kind": "cost.step", "v": 1, "label": "train_step", "phase": "train",
            "flops": 2.5e11, "images": 8, "steps_per_call": 1, "peak_flops": 9.89e14,
            "source": "dispatch"},
           {"kind": "cost.memory", "v": 1, "label": "train_step", "phase": "train",
            "total_bytes": 1 << 30, "capacity_bytes": 80 << 30, "headroom_pct": 37.5,
            "source": "graph"},
           {"kind": "compile", "event": "cuda_graph_capture", "dur_s": 1.25, "mono": 1000.5},
           {"kind": "span", "v": 1, "name": "ckpt_save", "t0": 1011.0, "dur": 0.75,
            "track": "ckpt"},
           {"kind": "nonfinite", "epoch": 1, "batch": 3, "policy": "skip"}],
        1: [{"kind": "clock", "t": 0.0, "unix": 1.7e9, "mono": 500.0}]
        + [_span(1, "step", 500.0 + i, 0.2 + 0.001 * i, batch=i, n=8) for i in range(10)]
        + [{"kind": "stall", "age_s": 30.0, "count": 1},
           {"kind": "dispatch.wedge", "age_s": 31.0},
           {"kind": "cost.memory", "v": 1, "label": "eval_step", "phase": "eval",
            "total_bytes": 1 << 29, "capacity_bytes": 80 << 30, "headroom_pct": 12.25,
            "source": "graph"}],
        2: [{"kind": "clock", "t": 0.0, "unix": 1.7e9, "mono": 0.0}]
        + [_span(2, "fold_window", i * 1.0, 0.8, batch=i * 4, n=4) for i in range(4)],
    }
    second = {
        0: [_span(0, "step", 1020.0 + i, 0.4, batch=20 + i, n=8) for i in range(6)]
        + [{"kind": "compile", "event": "cuda_graph_capture", "dur_s": 0.5, "mono": 1021.0},
           {"kind": "span", "v": 1, "name": "ckpt_restore", "t0": 1022.0, "dur": 0.25,
            "track": "ckpt"}],
        1: [_span(1, "step", 520.0 + i, 0.3, batch=20 + i, n=8) for i in range(6)],
    }
    primary = [{"kind": "stall", "t": 0.0, "age_s": 30.0, "count": 1},
               {"kind": "train", "t": 0.0, "epoch": 1, "batch": 1, "loss": 1.0,
                "top1": 0.0, "topk": 0.0, "lr": 0.1}]
    return first, second, primary


def _write_batch(tmp_path, batch):
    for rank, recs in batch.items():
        _jl(_rank_path(tmp_path, rank), [{"rank": rank, **r} for r in recs])


def test_aggregator_snapshots_equal_jax(tmp_path):
    first, second, primary = _fixture_run(tmp_path)
    _jl(str(tmp_path / "metrics.jsonl"), primary, mode="w")
    _write_batch(tmp_path, first)
    trs = [(m.RunTailer(str(tmp_path)), m.LiveAggregator()) for m in (jlive, live)]
    out = [[], []]
    for i, (rt, agg) in enumerate(trs):
        agg.consume(*rt.poll())
        out[i].append(agg.snapshot(10.0, tail=rt.health()))
    _write_batch(tmp_path, second)
    serve = {"p50_ms": 5.0, "p99_ms": 40.0, "window_samples": 12, "queue_depth": 3,
             "occupancy": 0.5, "requests": 50, "rejected": 2, "degraded": 1,
             "replicas": 2, "routable": 2, "exemplars": [], "models": {}}
    for i, (rt, agg) in enumerate(trs):
        agg.consume(*rt.poll())
        out[i].append(agg.snapshot(6.0, serve=dict(serve), tail=rt.health()))
        out[i].append(agg.snapshot(1.0))  # an empty window: totals roll on
    _same(out[1], out[0])
    snap = out[1][0]
    assert snap["ranks"] == 3 and snap["steps"] == 24 and snap["events"]["stall"] == 1
    assert snap["straggler_skew"] > 1.0 and snap["mfu"] is not None
    assert snap["hbm_headroom_pct"] == 12.25 and snap["dispatch_wedges"] == 1


# ------------------------------------------- the rule engine against JAX's
def _snap(*, steps=16, compiles=0, stall=0, nonfinite=0, per_rank=None, img_per_sec=None,
          mfu=None, hbm=None, wedges=0, serve=None, total_steps=None):
    per_rank = per_rank or {"0": 100.0}
    p50s = list(per_rank.values())
    return {
        "v": 1, "window_s": 5.0, "ranks": len(per_rank), "steps": steps, "images": steps,
        "img_per_sec": img_per_sec, "mfu": mfu, "hbm_headroom_pct": hbm,
        "step": {"count": steps, "mean_ms": 100.0, "p50_ms": 100.0, "p90_ms": 110.0,
                 "p99_ms": 120.0, "max_ms": 130.0},
        "per_rank_p50_ms": per_rank,
        "straggler_skew": round(max(p50s) / min(p50s), 4) if len(p50s) > 1 else 1.0,
        "data_wait_frac": 0.05, "compiles": {"count": compiles, "wall_s": 0.0},
        "dispatch_wedges": wedges,
        "events": {"stall": stall, "data_error": 0, "nonfinite": nonfinite},
        "ckpt": {"saves": 0, "save_max_s": 0.0, "restores": 0},
        "serve": serve,
        "totals": {"steps": steps if total_steps is None else total_steps, "images": steps,
                   "compiles": compiles, "stall": stall, "data_error": 0,
                   "nonfinite": nonfinite},
    }


def _serve(p99=10.0, samples=9, rejected=0, degraded=0, models=None, exemplars=None):
    return {"p50_ms": 5.0, "p99_ms": p99, "window_samples": samples, "queue_depth": 0,
            "occupancy": 0.5, "requests": 50, "rejected": rejected, "degraded": degraded,
            "replicas": 1, "routable": 1, "exemplars": exemplars or [],
            "models": models or {}}


_EXS = [{"trace": f"{i:016x}", "latency_ms": 900.0 - i} for i in range(4)]
_TWO = {"0": 100.0, "1": 200.0}
# kind -> (rule spec, snapshot stream): each stream breaches, holds (dedup),
# clears, and breaches again
RULE_STREAMS = {
    "recompile-storm": ({"kind": "recompile-storm", "threshold": 3, "window_s": 15},
                        [_snap(steps=0, compiles=10, total_steps=0)]
                        + [_snap(compiles=c) for c in (0, 1, 4, 0, 0, 0, 0, 5, 0)]),
    "stall": ({"kind": "stall", "threshold": 1},
              [_snap(stall=s) for s in (0, 1, 2, 0, 0, 1, 0)]),
    "nonfinite": ({"kind": "nonfinite", "threshold": 1, "clear_windows": 1},
                  [_snap(nonfinite=s) for s in (0, 1, 0, 1, 1, 0)]),
    "straggler-skew": ({"kind": "straggler-skew", "threshold": 1.5, "breach_windows": 2,
                        "min_steps": 8},
                       [_snap(per_rank=_TWO), _snap(per_rank={"0": 100.0, "1": 110.0}),
                        _snap(per_rank=_TWO), _snap(per_rank=_TWO),
                        _snap(per_rank=_TWO, steps=4), _snap(per_rank={"0": 300.0}),
                        _snap(per_rank={"0": 100.0, "1": 101.0}),
                        _snap(per_rank={"0": 100.0, "1": 101.0}),
                        _snap(per_rank=_TWO), _snap(per_rank=_TWO)]),
    "p99-breach": ({"kind": "p99-breach", "threshold": 250.0, "min_steps": 4},
                   [_snap(serve=_serve(40.0)), _snap(serve=None),
                    _snap(serve=_serve(900.0, samples=2)),
                    _snap(serve=_serve(900.0, exemplars=_EXS)), _snap(serve=_serve(950.0)),
                    _snap(serve=_serve(30.0)), _snap(serve=_serve(30.0)),
                    _snap(serve=_serve(400.0))]),
    "throughput-regression": ({"kind": "throughput-regression", "threshold": 40.0,
                               "baseline": 100.0, "breach_windows": 2, "min_steps": 4},
                              [_snap(img_per_sec=v) for v in (70.0, 50.0, 50.0, 55.0,
                                                              None, 90.0, 95.0, 10.0, 20.0)]
                              + [_snap(img_per_sec=10.0, steps=2)]),
    "mfu-regression": ({"kind": "mfu-regression", "threshold": 20.0, "baseline": 0.5},
                       [_snap(mfu=v) for v in (0.45, 0.3, None, 0.35, 0.5, 0.5, 0.1)]),
    "hbm-headroom-low": ({"kind": "hbm-headroom-low", "threshold": 10.0,
                          "breach_windows": 2},
                         [_snap(hbm=v) for v in (None, 20.0, 8.0, 5.0, 10.0, 30.0, 30.0,
                                                 9.5, 9.0)]),
    "dispatch-wedge": ({"kind": "dispatch-wedge", "threshold": 1, "window_s": 10},
                       [_snap(wedges=w) for w in (0, 1, 0, 0, 0, 0, 2)]),
    "backpressure": ({"kind": "backpressure", "threshold": 10, "window_s": 10},
                     [_snap(serve=_serve(rejected=r, exemplars=_EXS[:1] if r == 20 else None))
                      if r is not None else _snap(serve=None)
                      for r in (0, 5, 20, 25, None, 25, 25, 25, 40, 60)]),
    "slo-breach": ({"kind": "slo-breach", "threshold": 1.2, "min_steps": 4},
                   [_snap(serve=_serve(models=m)) for m in (
                       {"m": {"samples": 8, "p99_ms": 100.0, "target_ms": 300.0}},
                       {"m": {"samples": 2, "p99_ms": 900.0, "target_ms": 300.0}},
                       {"m": {"samples": 50, "p99_ms": 900.0, "target_ms": None}},
                       {"m": {"samples": 8, "p99_ms": 450.0, "target_ms": 300.0},
                        "length:short": {"samples": 9, "p99_ms": 10.0, "target_ms": 50.0}},
                       {"m": {"samples": 8, "p99_ms": 10.0, "target_ms": 300.0}},
                       {"m": {"samples": 8, "p99_ms": 10.0, "target_ms": 300.0}},
                       {"length:short": {"samples": 9, "p99_ms": 90.0, "target_ms": 50.0}})]),
    "degrade-spill": ({"kind": "degrade-spill", "threshold": 5, "window_s": 10},
                      [_snap(serve=_serve(degraded=d)) for d in (0, 3, 9, 12, 12, 12, 12,
                                                                 30)]),
}


def test_rule_streams_cover_every_kind():
    assert set(RULE_STREAMS) == set(live.RULE_KINDS) == set(jlive.RULE_KINDS)
    assert live.RULE_KINDS == jlive.RULE_KINDS


@pytest.mark.parametrize("kind", sorted(RULE_STREAMS))
def test_rule_engine_raises_jax_alerts(kind):
    spec, stream = RULE_STREAMS[kind]
    port = live.RuleEngine([live.AlertRule(dict(spec))], interval_s=5.0)
    ref = jlive.RuleEngine([jlive.AlertRule(dict(spec))], interval_s=5.0)
    fired = []
    for snap in stream:
        got = port.evaluate(copy.deepcopy(snap))
        want = ref.evaluate(copy.deepcopy(snap))
        _same(got, want)
        assert port.active_rules() == ref.active_rules()
        fired.extend(got)
        _same(live.render_prometheus(snap, port), jlive.render_prometheus(snap, ref))
    assert port.fired_counts() == ref.fired_counts()
    assert port.fired_counts()[kind] >= 2, fired  # breached, cleared, breached again
    for a in fired:
        schema.check_fields("alert", {"kind", "t", *a})


def test_load_rules_and_validation_match_jax(tmp_path):
    path = os.path.join(ROOT, "config", "monitor_rules.yaml")
    assert [r.to_dict() for r in live.load_rules(path)] == [
        r.to_dict() for r in jlive.load_rules(path)]
    for text, match in (("rules:\n  - kind: volcano\n    threshold: 1\n", "unknown rule kind"),
                        ("rules:\n  - kind: stall\n", "threshold"),
                        ("rules:\n  - kind: stall\n    threshold: 1\n"
                         "  - kind: stall\n    threshold: 2\n", "duplicate"),
                        ("rules:\n  - kind: stall\n    threshold: 1\n    blorp: 2\n",
                         "unknown keys")):
        bad = tmp_path / "bad.yaml"
        bad.write_text(text)
        with pytest.raises(live.RuleError, match=match) as got:
            live.load_rules(str(bad))
        with pytest.raises(jlive.RuleError) as want:
            jlive.load_rules(str(bad))
        assert str(got.value) == str(want.value)


def test_prometheus_text_equals_jax_with_serve_and_ledger():
    snap = _snap(steps=10, compiles=2, stall=1, img_per_sec=123.4, mfu=0.25, hbm=42.5,
                 wedges=1, serve=_serve(p99=77.5, rejected=3))
    rules = [{"kind": k, "threshold": 1} for k in ("stall", "nonfinite", "dispatch-wedge")]
    port = live.RuleEngine([live.AlertRule(dict(r)) for r in rules], interval_s=5.0)
    ref = jlive.RuleEngine([jlive.AlertRule(dict(r)) for r in rules], interval_s=5.0)
    port.evaluate(copy.deepcopy(snap))
    ref.evaluate(copy.deepcopy(snap))
    text = live.render_prometheus(snap, port)
    assert text == jlive.render_prometheus(snap, ref)
    assert live.render_prometheus(snap) == jlive.render_prometheus(snap)
    assert 'dtpu_alert_active{rule="stall"} 1' in text and "dtpu_serve_p99_ms 77.5" in text


@pytest.mark.parametrize("kind", LIVE_KINDS)
def test_live_plane_kinds_have_the_jax_fields(kind):
    assert schema.KINDS[kind] == jschema.KINDS[kind]


def test_monitor_tick_writes_schema_valid_records(tmp_path):
    _write_rank(tmp_path, 0, [100.0] * 4,
                extra=[{"kind": "nonfinite", "epoch": 1, "batch": 2, "policy": "skip"}])
    eng = live.RuleEngine([live.AlertRule({"kind": "nonfinite", "threshold": 1})],
                          interval_s=1.0)
    mon = live.Monitor(str(tmp_path), eng)
    out = mon.tick()
    mon.close()
    assert [a["rule"] for a in out["alerts"]] == ["nonfinite"]
    recs = [json.loads(ln) for ln in open(tmp_path / "MONITOR.jsonl").read().splitlines()]
    assert [r["kind"] for r in recs] == ["monitor.snapshot", "alert"]
    for r in recs:
        schema.validate_record(r)
    assert live.RunTailer(str(tmp_path)).rescan() == [0]


def test_metrics_http_endpoint():
    import urllib.request

    srv = live.MetricsHTTPServer(port=0).start()
    try:
        srv.update("dtpu_test 1\n")
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/metrics", timeout=5) as r:
            assert r.status == 200 and r.read() == b"dtpu_test 1\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{srv.host}:{srv.port}/nope", timeout=5)
    finally:
        srv.stop()


# ----------------------------------------------- a port toy run on the CPU
def _toy_cfg(out_dir: str, shards: str):
    from distribuuuu_tpu_torch.config import cfg

    reset_port_cfg()
    cfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 4, "DEVICE.PLATFORM", "cpu",
        "DEVICE.COMPUTE_DTYPE", "float32", "TRAIN.BATCH_SIZE", 4, "TRAIN.IM_SIZE", 32,
        "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "TEST.BATCH_SIZE", 8, "TEST.IM_SIZE", 32,
        "DATA.FORMAT", "shards", "DATA.SHARDS_BLOCK", 4, "DATA.SHARDS_WINDOW", 16,
        "OPTIM.MAX_EPOCH", 1, "RNG_SEED", 0, "TRAIN.DATASET", shards, "TEST.DATASET",
        shards, "OUT_DIR", out_dir])
    return cfg


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The soak's corpus (4 images a class, 4 batches) and one monitored
    resnet18 epoch on it: (shards root, run dir, the monitor's snapshots)."""
    from distribuuuu_tpu_torch import soak, trainer

    work = tmp_path_factory.mktemp("toy")
    shards, _ = soak.make_corpus(str(work), 4)
    run = str(work / "run")
    gen = few_threads(2)
    next(gen)
    try:
        _toy_cfg(run, shards)
        trainer.train_model()
    finally:
        next(gen, None)
        spans.close_telemetry()
        reset_port_cfg()
    return shards, run


def test_report_equals_the_jax_tool_on_a_port_run(toy):
    _, run = toy
    got, want = report.build_report(run), run_report.build_report(run)
    _same(got, want)
    assert got["step"]["count"] == 4 and got["checkpoint"]["saves"] == 1
    assert got["img_per_sec"] is not None  # the timeline attribution ran
    worse = json.loads(json.dumps(got))
    worse["step"]["p50_ms"] *= 2.0
    for tol in (35.0, 200.0):
        _same(report.compare(worse, got, tol, {"step_ms_p99": 250.0}),
              run_report.compare(worse, got, tol, {"step_ms_p99": 250.0}))
    assert not report.compare(worse, got, 35.0, {})["ok"]


def test_aggregator_totals_equal_the_report(toy):
    _, run = toy
    rt, agg = live.RunTailer(run), live.LiveAggregator()
    agg.consume(*rt.poll())
    snap = agg.snapshot(1.0)
    rep = report.build_report(run)
    assert snap["totals"]["steps"] == rep["step"]["count"]
    assert snap["totals"]["compiles"] == rep["recompiles"]["count"]
    assert snap["ckpt"]["saves"] == rep["checkpoint"]["saves"]
    assert {k: snap["events"][k] for k in rep["events"]} == rep["events"]
    _same(snap["step"], rep["step"])
    assert snap["straggler_skew"] == rep["straggler_skew"]


def _cli(*args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.telemetry.live", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=120)


def test_cli_dry_validates_rules_and_fails_on_broken(tmp_path):
    out = _cli("--dry")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "12 rule(s) OK" in out.stdout
    bad = tmp_path / "bad.yaml"
    bad.write_text("rules:\n  - kind: nope\n    threshold: 1\n")
    out = _cli("--dry", "--rules", str(bad))
    assert out.returncode == 1 and "unknown rule kind" in out.stdout


def test_cli_once_over_a_finished_run(tmp_path, toy):
    _write_rank(tmp_path, 0, [100.0] * 4, extra=[{"kind": "stall", "age_s": 2.0, "count": 1}])
    out = _cli(str(tmp_path), "--once")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ALERT stall" in out.stdout and "1 alert(s) fired" in out.stdout
    assert os.path.exists(tmp_path / "MONITOR.jsonl")
    _, run = toy  # the port run: one snapshot line, no alert
    out = _cli(run, "--once", "--json-lines", "--rules",
               os.path.join(ROOT, "config", "monitor_rules.yaml"))
    assert out.returncode == 0 and "0 alert(s) fired" in out.stdout
    snap = json.loads(next(ln for ln in out.stdout.splitlines() if ln.startswith("{")))
    assert snap["totals"]["steps"] == 4


def test_a_monitor_attached_changes_no_training_bit(tmp_path, toy):
    """Two f32 toy epochs, one with a Monitor tailing its directory (and
    writing its own MONITOR.jsonl) every 20 ms, one with telemetry off and
    no monitor: the checkpoints are bitwise equal."""
    from distribuuuu_tpu_torch import trainer

    shards, _ = toy
    payloads = {}
    gen = few_threads(2)
    next(gen)
    try:
        for watched in (True, False):
            out_dir = str(tmp_path / ("on" if watched else "off"))
            cfg = _toy_cfg(out_dir, shards)
            cfg.TELEMETRY.ENABLED = watched
            stop, watcher, mon = threading.Event(), None, None
            if watched:
                os.makedirs(out_dir, exist_ok=True)
                mon = live.Monitor(out_dir, live.RuleEngine(
                    live.load_rules(os.path.join(ROOT, "config", "monitor_rules.yaml")),
                    interval_s=0.02))
                watcher = threading.Thread(target=mon.run, args=(0.02,),
                                           kwargs={"should_stop": stop.is_set}, daemon=True)
                watcher.start()
            trainer.train_model()
            stop.set()
            if watcher is not None:
                watcher.join(10)
                mon.close()
            payloads[watched] = torch.load(
                os.path.join(out_dir, "checkpoints", "ckpt_ep_000.pth"), weights_only=True)
    finally:
        next(gen, None)
    assert os.path.exists(tmp_path / "on" / "MONITOR.jsonl")
    a, b = payloads[True], payloads[False]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["opt"]["m"]:
        assert torch.equal(a["opt"]["m"][k], b["opt"]["m"][k]), k
    assert a["step"] == b["step"] == 4
