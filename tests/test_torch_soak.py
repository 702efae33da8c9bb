"""The port's soak referee (distribuuuu_tpu_torch/soak.py) against the
JAX package's (distribuuuu_tpu/soak.py): ``--dry``, the interval matrix
and the rule set equal to JAX's, and the whole ``--smoke`` run on the CPU
(control and nonfinite intervals, live-monitored, gates evaluated, the
monitored control run bitwise the unmonitored rerun; about 45 s, so it
runs in tier-1, unmarked)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from distribuuuu_tpu import soak as jsoak
from distribuuuu_tpu_torch import soak
from distribuuuu_tpu_torch.telemetry import schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soak(*args, cwd=ROOT, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.soak", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


def test_dry_validates_plan_and_rules_as_jax():
    out = _soak("--dry")
    assert out.returncode == 0, out.stdout + out.stderr
    want = subprocess.run([sys.executable, os.path.join("tools", "soak.py"), "--dry"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout == want.stdout
    assert "5 intervals" in out.stdout and "p99_burst" in out.stdout


@pytest.mark.parametrize("n_batches", [1, 3, 8, 24, 64, 1000])
def test_interval_matrix_is_jax(n_batches):
    assert soak.interval_matrix(n_batches) == jsoak.interval_matrix(n_batches)


@pytest.mark.parametrize("baseline, p99_ms", [(None, None), (100.0, None), (None, 250.0),
                                              (37.5, 600.0)])
def test_build_rules_is_jax(baseline, p99_ms):
    got = soak.build_rules(baseline=baseline, p99_ms=p99_ms)
    want = jsoak.build_rules(baseline=baseline, p99_ms=p99_ms)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]


def test_odd_overrides_are_refused():
    out = _soak("--dry", "DEVICE.PLATFORM")
    assert out.returncode != 0 and "pairs" in out.stderr


def test_smoke_verdict_on_the_cpu(tmp_path):
    """control + nonfinite on the CPU at 8 images a class: the nonfinite
    injection raises exactly its alert, the control none, the gate is
    evaluated and passes, and the monitored control run is bitwise the
    unmonitored rerun; the soak's event stream obeys the schema."""
    out_json = str(tmp_path / "SOAK_smoke.json")
    out = _soak("--smoke", "--per-class", "8", "--work-dir", str(tmp_path / "work"),
                "--out", out_json, "DEVICE.PLATFORM", "cpu",
                extra_env={"OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    verdict = json.load(open(out_json))
    assert verdict["ok"] is True and verdict["platform"] == "cpu"
    assert verdict["control_clean"] is True and verdict["alerts_exact"] is True
    assert verdict["divergence"]["bit_identical"] is True
    assert verdict["serve"] is None  # --smoke without --serve, as JAX's
    names = {i["name"]: i for i in verdict["intervals"]}
    assert list(names) == ["control", "nonfinite"]
    assert names["control"]["raised_alerts"] == []
    assert names["nonfinite"]["raised_alerts"] == ["nonfinite"]
    assert names["nonfinite"]["gate"]["ok"] is True and names["nonfinite"]["gate"]["checked"]
    events = [json.loads(ln) for ln in open(tmp_path / "work" / "soak_events.jsonl")]
    assert {e["kind"] for e in events} == {"soak.interval", "soak.verdict"}
    for e in events:
        schema.validate_record(e)
