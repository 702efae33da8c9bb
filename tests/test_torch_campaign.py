"""The port's serving campaigns (distribuuuu_tpu_torch/serve/campaign/ and
serve_campaign.py) against the JAX package's: every shipped campaign YAML
parses to JAX's spec and schedules bitwise JAX's schedule; JAX's
parse-rejection cases raise JAX's messages; model envelopes and the
payload banks are JAX's bytes; routing, overflow and verbatim
backpressure over fake socket replicas (tests/test_campaign.py's cases);
the runner's snapshots have JAX's keys; and one whole short campaign runs
through real port replicas on the CPU and ends ok."""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import socket
import sys
import threading

import pytest
from torch_port_util import reset_port_cfg

from distribuuuu_tpu.serve import protocol as jprotocol
from distribuuuu_tpu.serve.campaign import dsl as jdsl
from distribuuuu_tpu.serve.campaign.runner import CampaignRunner as JRunner
from distribuuuu_tpu.serve.fleet import Router as JRouter
from distribuuuu_tpu_torch import serve_campaign
from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.serve.campaign import CampaignRunner, dsl
from distribuuuu_tpu_torch.serve.fleet import Router
from distribuuuu_tpu_torch.telemetry import live

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN_DIR = os.path.join(ROOT, "config", "campaigns")
SHIPPED = sorted(glob.glob(os.path.join(CAMPAIGN_DIR, "*.yaml")))
OK_RESP = json.dumps({"pred": 1, "topk": [1, 0], "logits": [0.0, 1.0]}).encode()
BUSY_RESP = json.dumps({"error": "queue_full", "retry_after_ms": 5.0}).encode()


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


def _doc(**over) -> dict:
    doc = {
        "campaign": 1, "name": "toy", "seed": 7, "interval_s": 1.0,
        "models": [{"name": "a", "p99_slo_ms": 100.0}],
        "rules": [{"kind": "p99-breach", "threshold": 50.0}],
        "phases": [{"name": "control", "kind": "steady", "duration_s": 2,
                    "rate_rps": 3, "expect": []}],
    }
    doc.update(over)
    return doc


# -- the DSL against JAX's ---------------------------------------------------

@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: os.path.basename(p))
def test_shipped_campaign_parses_and_schedules_as_jax(path):
    port, ref = dsl.load_campaign(path), jdsl.load_campaign(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    sched = dsl.build_schedule(port)
    assert sched == jdsl.build_schedule(ref) and sched
    assert dsl.schedule_hash(sched) == jdsl.schedule_hash(sched)
    assert [dsl.phase_window(port, i) for i in range(len(port.phases))] == [
        jdsl.phase_window(ref, i) for i in range(len(ref.phases))]


def test_shipped_campaigns_cover_the_matrix():
    assert {dsl.load_campaign(p).name for p in SHIPPED} >= {
        "degrade_under_pressure", "lm_decode", "long_context", "rolling_update"}
    assert dsl.CAMPAIGN_RULE_KINDS == jdsl.CAMPAIGN_RULE_KINDS
    assert set(dsl.CAMPAIGN_RULE_KINDS) <= set(live.RULE_KINDS)
    assert dsl.PHASE_KINDS == jdsl.PHASE_KINDS


def test_schedules_of_every_phase_kind_hash_as_jax():
    doc = _doc(models=[{"name": "a"}, {"name": "b"}], seed=3, phases=[
        {"name": "ramp", "kind": "diurnal", "duration_s": 5, "rate_rps": 2,
         "peak_rps": 20, "expect": [], "mix": {"a": 3.0, "b": 1.0}},
        {"name": "tail", "kind": "heavy_tail", "duration_s": 5, "rate_rps": 4,
         "size_alpha": 1.1, "size_max": 6, "expect": []},
        {"name": "crowd", "kind": "flash", "duration_s": 4, "rate_rps": 2,
         "burst_x": 50, "burst_window": [0.4, 0.6], "expect": []},
        {"name": "upd", "kind": "rolling_update", "duration_s": 3, "rate_rps": 2,
         "at_frac": 0.5, "expect": [], "update": {"model": "b", "overrides": {}}},
    ])
    port, ref = dsl.parse_campaign(json.loads(json.dumps(doc))), jdsl.parse_campaign(doc)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    sched = dsl.build_schedule(port)
    assert sched == jdsl.build_schedule(ref)
    assert any(size > 1 for _t, _m, size in sched) and {m for _t, m, _s in sched} == {"a", "b"}


@pytest.mark.parametrize("mutation, match", [
    ({"campaign": 2}, "campaign: 1"),
    ({"typo_key": 1}, "unknown campaign keys"),
    ({"models": []}, "at least one model"),
    ({"models": [{"name": "a", "bogus": 1}]}, "unknown model keys"),
    ({"models": [{"name": "a", "overflow_to": "ghost"}]}, "undeclared"),
    ({"phases": []}, "at least one phase"),
    ({"phases": [{"name": "p", "kind": "tsunami", "duration_s": 1,
                  "rate_rps": 1, "expect": []}]}, "unknown phase kind"),
    ({"phases": [{"name": "p", "kind": "steady", "duration_s": 1,
                  "rate_rps": 1, "expect": ["stall"]}]}, "un-armable"),
    ({"phases": [{"name": "p", "kind": "steady", "duration_s": 1,
                  "rate_rps": 1, "expect": ["backpressure"]}]}, "arms only"),
    ({"phases": [{"name": "p", "kind": "rolling_update", "duration_s": 1,
                  "rate_rps": 1, "expect": []}]}, "update.model"),
    ({"phases": [{"name": "p", "kind": "steady", "duration_s": 1,
                  "rate_rps": 1, "expect": [], "mix": {"ghost": 1.0}}]},
     "unknown models"),
], ids=["version", "spec-key", "no-models", "model-key", "overflow-ghost",
        "no-phases", "phase-kind", "unarmable-expect", "unarmed-expect",
        "update-model", "mix-ghost"])
def test_parse_campaign_rejects_as_jax(mutation, match):
    with pytest.raises(ValueError, match=match) as got:
        dsl.parse_campaign(_doc(**mutation))
    with pytest.raises(ValueError) as want:
        jdsl.parse_campaign(_doc(**mutation))
    assert str(got.value) == str(want.value)


# -- wire bytes against JAX's ------------------------------------------------

@pytest.mark.parametrize("model, payload", [
    ("resnet18", b"\x93NUMPYfake-image-bytes"),
    ("gpt_nano", protocol.ctrl_request("generate", tokens=[1, 2, 3])),
    ("m" * 255, b""),
    ("résnet-ü", bytes(range(256))),
])
def test_model_envelope_bytes_are_jax(model, payload):
    frame = protocol.model_envelope(model, payload)
    assert frame == jprotocol.model_envelope(model, payload)
    assert protocol.split_model_envelope(frame) == (model, payload)


def test_model_envelope_refusals_are_jax():
    for bad in ("", "x" * 256):
        with pytest.raises(ValueError, match="1..255") as got:
            protocol.model_envelope(bad, b"p")
        with pytest.raises(ValueError) as want:
            jprotocol.model_envelope(bad, b"p")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="truncated"):
        protocol.split_model_envelope(protocol.MODEL_MAGIC + bytes([9]) + b"ab")


def test_payload_banks_are_the_jax_tool_bytes():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import serve_campaign as jtool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    assert serve_campaign.payload_bank() == jtool.payload_bank()
    assert serve_campaign.lm_payload_bank() == jtool.lm_payload_bank()
    assert serve_campaign.lm_long_payload_bank() == jtool.lm_long_payload_bank()
    assert serve_campaign.TOPOLOGY == jtool.TOPOLOGY
    spec = dsl.load_campaign(os.path.join(CAMPAIGN_DIR, "degrade.yaml"))
    assert serve_campaign.fleet_specs(spec) == jtool.fleet_specs(
        jdsl.load_campaign(os.path.join(CAMPAIGN_DIR, "degrade.yaml")))


@pytest.mark.parametrize("make_cfg", ["base_cfg", "lm_base_cfg", "long_context_cfg"])
def test_campaign_serve_configs_keep_the_jax_knobs(make_cfg, tmp_path):
    """The port's config makers set the JAX tool's serving knobs (queue, batch,
    tiles, budgets, fleet); the platform is left to the caller."""
    import distribuuuu_tpu.config as jconfig

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import serve_campaign as jtool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    try:
        want = getattr(jtool, make_cfg)(str(tmp_path)).clone()
    finally:
        jconfig.reset_cfg()
    got = getattr(serve_campaign, make_cfg)(str(tmp_path))
    keys = ["SERVE.MAX_BATCH", "SERVE.MAX_WAIT_MS", "SERVE.MAX_QUEUE", "SERVE.FLEET.AUTOSCALE",
            "SERVE.FLEET.MIN_REPLICAS", "SERVE.FLEET.HEALTH_PERIOD_S", "MODEL.ARCH",
            "MODEL.NUM_CLASSES", "DEVICE.COMPUTE_DTYPE", "TRAIN.IM_SIZE", "TEST.IM_SIZE",
            "RNG_SEED", "LM.SEQ_LEN", "GENERATE.PROMPT_LEN", "GENERATE.MAX_NEW_TOKENS",
            "GENERATE.BATCH_TILES", "GENERATE.CACHE_TILES", "GENERATE.CHUNK_PREFILL",
            "SERVE.LONG_PROMPT_THRESHOLD", "SERVE.LONG_MAX_QUEUE", "SERVE.SHORT_P99_SLO_MS"]
    if make_cfg == "base_cfg":
        keys += ["MODEL.BN_GROUP", "DATA.DEVICE_NORMALIZE"]

    def at(c, key):
        for part in key.split("."):
            c = c[part]
        return c

    assert {k: at(got, k) for k in keys} == {k: at(want, k) for k in keys}
    assert want.DEVICE.PLATFORM == "cpu" and got.DEVICE.PLATFORM == "auto"


# -- fake socket replicas ----------------------------------------------------

class FakeReplica:
    """A localhost socket speaking the serve framing with a scripted
    responder (a list of frames answers a generate stream)."""

    def __init__(self, responder):
        self.responder = responder
        self.listener = protocol.open_listener("127.0.0.1", 0)
        self.port = self.listener.getsockname()[1]
        self.requests = 0
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        self.listener.settimeout(0.05)
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn):
        with conn:
            while True:
                try:
                    payload = protocol.recv_frame(conn)
                except (OSError, ValueError):
                    return
                if payload is None:
                    return
                self.requests += 1
                out = self.responder(payload)
                try:
                    for frame in (out if isinstance(out, list) else [out]):
                        protocol.send_frame(conn, frame)
                except OSError:
                    return

    def close(self):
        self._stop.set()
        self.listener.close()


@pytest.fixture
def replicas():
    made = []

    def make(responder):
        made.append(FakeReplica(responder))
        return made[-1]

    yield make
    for r in made:
        r.close()


def _multi_model_router(premium, economy, cls=Router):
    router = cls(request_timeout_s=5.0)
    router.register_model("resnet50", slo_class="premium", p99_slo_ms=300.0,
                          overflow_to="resnet18")
    router.register_model("resnet18", slo_class="economy", p99_slo_ms=600.0)
    for srv, model in ((premium, "resnet50"), (economy, "resnet18")):
        router.mark_routable(router.add_replica("127.0.0.1", srv.port, model=model).id)
    return router


def test_unknown_model_refused_with_registered_list(replicas):
    premium, economy = replicas(lambda p: OK_RESP), replicas(lambda p: OK_RESP)
    router = _multi_model_router(premium, economy)
    frame = protocol.model_envelope("resnet152", b"img")
    resp = router.dispatch(frame)
    assert json.loads(resp) == {"error": "unknown_model", "model": "resnet152",
                                "models": ["resnet18", "resnet50"]}
    assert resp == _multi_model_router(premium, economy, JRouter).dispatch(frame)
    assert premium.requests == 0 and economy.requests == 0
    assert router.stats()["unknown_model"] == 1


def test_model_routing_is_model_exclusive(replicas):
    premium, economy = replicas(lambda p: OK_RESP), replicas(lambda p: OK_RESP)
    router = _multi_model_router(premium, economy)
    for _ in range(4):
        assert json.loads(router.dispatch(protocol.model_envelope("resnet18", b"x")))["pred"] == 1
    assert economy.requests == 4 and premium.requests == 0
    st = router.stats()
    assert st["models"]["resnet18"]["requests"] == 4
    assert st["models"]["resnet50"]["requests"] == 0
    assert [p["model"] for p in st["per_replica"]] == ["resnet50", "resnet18"]


def test_slo_overflow_reroutes_to_cheap_model(replicas):
    premium, economy = replicas(lambda p: BUSY_RESP), replicas(lambda p: OK_RESP)
    router = _multi_model_router(premium, economy)
    for _ in range(3):
        assert json.loads(router.dispatch(protocol.model_envelope("resnet50", b"i")))["pred"] == 1
    st = router.stats()
    assert st["degraded"] == 3
    assert st["models"]["resnet50"]["degraded_out"] == 3
    assert st["models"]["resnet18"]["degraded_in"] == 3
    assert st["models"]["resnet50"]["rejected"] == 0
    assert economy.requests == 3


def test_saturation_without_overflow_passes_busy_verbatim(replicas):
    premium, economy = replicas(lambda p: BUSY_RESP), replicas(lambda p: BUSY_RESP)
    router = _multi_model_router(premium, economy)
    assert router.dispatch(protocol.model_envelope("resnet18", b"img")) == BUSY_RESP
    st = router.stats()
    assert st["models"]["resnet18"]["rejected"] == 1 and st["degraded"] == 0


def test_dispatch_generate_returns_the_final_frame(replicas):
    """The runner's LM path: a stream's token frames are drained and its
    final frame returned, as JAX's router does; a busy replica's rejection
    comes back verbatim; an unknown model is refused."""
    tokens = [json.dumps({"token": t, "i": i}).encode() for i, t in enumerate((5, 6, 7))]
    done = json.dumps({"stream": "done", "n": 3}).encode()
    lm = replicas(lambda p: tokens + [done])
    busy = replicas(lambda p: BUSY_RESP)
    req = protocol.ctrl_request("generate", tokens=[1, 2], max_new_tokens=3)
    for cls in (Router, JRouter):
        router = cls(request_timeout_s=5.0)
        router.register_model("gpt_nano")
        router.register_model("gpt_busy")
        router.mark_routable(router.add_replica("127.0.0.1", lm.port, model="gpt_nano").id)
        router.mark_routable(router.add_replica("127.0.0.1", busy.port, model="gpt_busy").id)
        assert router.dispatch_generate(req, model="gpt_nano") == done
        assert router.dispatch_generate(req, model="gpt_busy") == BUSY_RESP
        assert json.loads(router.dispatch_generate(req, model="nope"))["error"] == "unknown_model"
        assert router.stats()["models"]["gpt_nano"]["requests"] == 1


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def test_runner_snapshot_keys_are_jax(replicas):
    premium, economy = replicas(lambda p: OK_RESP), replicas(lambda p: OK_RESP)
    doc = _doc(rules=[{"kind": k, "threshold": 1e9} for k in dsl.CAMPAIGN_RULE_KINDS])
    snaps = []
    for cls, runner_cls, parse, prot in ((Router, CampaignRunner, dsl.parse_campaign, protocol),
                                         (JRouter, JRunner, jdsl.parse_campaign, jprotocol)):
        router = _multi_model_router(premium, economy, cls)
        router.dispatch(prot.model_envelope("resnet50", b"img"))
        runner = runner_cls(parse(doc), router, payload_for=lambda m: b"img")
        snaps.append(runner._snapshot())
        runner._pool.shutdown(wait=False)
    assert _keys(snaps[0]) == _keys(snaps[1])
    assert snaps[0]["totals"]["steps"] == 1
    assert set(snaps[0]["serve"]["models"]) == {"resnet18", "resnet50"}
    engine = live.RuleEngine([live.AlertRule(dict(r)) for r in doc["rules"]], 1.0)
    assert engine.evaluate(snaps[0]) == []


# -- one whole campaign through real port replicas on the CPU -----------------

SHORT_CAMPAIGN = """\
campaign: 1
name: short_degrade
seed: 5
interval_s: 0.5
models:
  - {name: resnet50, slo_class: premium, p99_slo_ms: 300, overflow_to: resnet18}
  - {name: resnet18, slo_class: economy, p99_slo_ms: 600}
rules:
  - {kind: degrade-spill, threshold: 3.0, window_s: 1, warmup_s: 2}
phases:
  - {name: control, kind: steady, duration_s: 3, rate_rps: 2, mix: {resnet50: 1.0},
     expect: []}
  - {name: pressure, kind: flash, duration_s: 6, rate_rps: 2, burst_x: 100,
     burst_window: [0.3, 0.6], mix: {resnet50: 1.0}, expect: [degrade-spill]}
  - {name: calm, kind: steady, duration_s: 3, rate_rps: 1, mix: {resnet50: 1.0},
     expect: []}
"""


def test_a_short_campaign_through_real_replicas_ends_ok(tmp_path, monkeypatch):
    """resnet50 (premium, overflow to resnet18) and resnet18 replicas under
    base_cfg on the CPU (one thread each): the flash crowd saturates the
    premium replica and spills (exactly degrade-spill), control and calm
    stay silent, no request fails, the schedule is deterministic."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the replicas' torch threads
    path = tmp_path / "short.yaml"
    path.write_text(SHORT_CAMPAIGN)
    logs = []
    verdict = serve_campaign.run_campaign(str(path), str(tmp_path / "work"), logs.append,
                                          opts=["DEVICE.PLATFORM", "cpu"])
    assert verdict["ok"] and verdict["deterministic"], json.dumps(verdict)[-3000:]
    assert verdict["alerts_exact"] and verdict["control_clean"]
    assert [p["raised"] for p in verdict["phases"]] == [[], ["degrade-spill"], []]
    assert sum(p["counts"]["failed"] for p in verdict["phases"]) == 0
    assert verdict["models"]["resnet18"]["degraded_in"] > 0
    assert all(p["send_lag_ms"]["n"] > 0 for p in verdict["phases"])
    assert verdict["schedule_hash"] == jdsl.schedule_hash(
        jdsl.build_schedule(jdsl.load_campaign(str(path))))


def test_submits_during_decode_keep_every_stream_whole(tmp_path):
    """The LM engine decodes outside its lock, so submitters (the
    replica's connection threads under a campaign's burst) enqueue or are
    refused while the scheduler decodes. 16 threads submit one prompt 12
    times each, the interpreter switching threads every 10 µs: every
    submit is either refused (``QueueFullError``) or streams the same
    greedy tokens as a lone request, all of them, and the engine's
    counters add up."""
    import time

    import torch

    from distribuuuu_tpu_torch.lm import service as lm_service
    from distribuuuu_tpu_torch.serve.admission import QueueFullError

    serve_campaign.lm_base_cfg(str(tmp_path), opts=["DEVICE.PLATFORM", "cpu",
                                                    "GENERATE.EOS_ID", -1])
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = lm_service.engine_from_cfg()
    eng.start()
    switch = sys.getswitchinterval()
    try:
        prompt = [5, 17, 42, 7]
        want = eng.submit(prompt, 6).result(timeout=60)
        assert len(want) == 6
        got, refused, lock = [], [0], threading.Lock()

        def client():
            for _ in range(12):
                try:
                    stream = eng.submit(prompt, 6)
                except QueueFullError:
                    with lock:
                        refused[0] += 1
                    time.sleep(0.001)
                    continue
                toks = stream.result(timeout=60)
                with lock:
                    got.append(toks)

        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        eng.drain()
        torch.set_num_threads(prev)
    assert len(got) + refused[0] == 16 * 12 and got and refused[0]
    assert all(toks == want for toks in got)
    st = eng.stats()
    assert st["requests"] == len(got) + 1 and st["active"] == 0 and st["queue_depth"] == 0
