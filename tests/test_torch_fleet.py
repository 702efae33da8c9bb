"""The serving fleet of the port (distribuuuu_tpu_torch/serve/fleet/):
JAX's tests/test_fleet.py cases through injected spawn and probe (the
least-loaded policy from synthetic snapshots, warm-up-gated routability,
drain-before-exit ordering, idempotent reroute, verbatim backpressure, the
autoscaler's hysteresis, the fleet.* records) and the router's length
classes of tests/test_serve_length_classes.py, on the port's modules;
``load_score`` and ``pick_replica`` equal to JAX's on the same snapshots;
and one ``serve_net --fleet 2`` run on the CPU with toy replicas."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from torch_port_util import reset_port_cfg

from distribuuuu_tpu.serve.fleet import router as jrouter
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.serve.fleet import (
    AutoscalePolicy,
    Autoscaler,
    LoadSnapshot,
    Observation,
    PoolManager,
    Router,
    load_score,
    pick_replica,
    warmed_up,
)
from distribuuuu_tpu_torch.telemetry import schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


# -- least-loaded policy (pure, synthetic snapshots) -------------------------

def test_load_score_orders_by_queued_work():
    idle = LoadSnapshot(inflight=0, queue_depth=0, occupancy=0.0, ewma_ms=5.0)
    queued = LoadSnapshot(inflight=2, queue_depth=4, occupancy=0.0, ewma_ms=5.0)
    slow = LoadSnapshot(inflight=0, queue_depth=0, occupancy=0.0, ewma_ms=50.0)
    full = LoadSnapshot(inflight=0, queue_depth=0, occupancy=1.0, ewma_ms=5.0)
    assert load_score(idle) < load_score(queued)
    assert load_score(idle) < load_score(slow)
    assert load_score(idle) < load_score(full)  # occupancy weighs in


def test_pick_replica_least_loaded_and_skips_unroutable():
    snaps = [
        LoadSnapshot(inflight=3, queue_depth=2, occupancy=0.9, ewma_ms=10.0),
        LoadSnapshot(inflight=0, queue_depth=0, occupancy=0.1, ewma_ms=10.0),
        None,  # unroutable (draining/dead/warming)
    ]
    assert pick_replica(snaps) == 1
    assert pick_replica([None, None, None]) is None
    assert pick_replica([]) is None


def test_pick_replica_round_robins_ties():
    # equally idle replicas share cold traffic via the rr tiebreak
    snaps = [LoadSnapshot(), LoadSnapshot(), LoadSnapshot()]
    picks = {pick_replica(snaps, rr=r) for r in range(3)}
    assert picks == {0, 1, 2}


def test_router_pick_from_registry_snapshots():
    """The router's pick over replica records whose queue depth/occupancy
    came from (synthetic) replica Registry stats snapshots."""
    router = Router()
    a = router.add_replica("127.0.0.1", 1001)
    b = router.add_replica("127.0.0.1", 1002)
    router.mark_routable(a.id)
    router.mark_routable(b.id)
    # a is deep in queued work per its last stats probe; b is idle
    a.stats = {"queue_depth": 12, "batch_occupancy": 1.0}
    b.stats = {"queue_depth": 0, "batch_occupancy": 0.2}
    a.ewma_ms = b.ewma_ms = 8.0
    for _ in range(4):
        assert router._pick(set()).id == b.id
    # draining stops routing even to the least-loaded replica
    router.mark_draining(b.id)
    assert router._pick(set()).id == a.id
    # excluded (already tried) + draining leaves nothing
    assert router._pick({a.id}) is None


# -- fakes for the lifecycle tests -------------------------------------------

class FakeHandle:
    """A fake replica process: records lifecycle calls, 'exits' when
    terminated or killed."""

    def __init__(self, events: list, rid: int):
        self.events = events
        self.rid = rid
        self.pid = 4000 + rid
        self._rc = None

    def poll(self):
        return self._rc

    def terminate(self):
        self.events.append(("terminate", self.rid))
        self._rc = 0

    def kill(self):
        self.events.append(("kill", self.rid))
        self._rc = -9

    def wait(self, timeout=None):
        return self._rc


def make_fake_pool(events, probe, **kw):
    router = Router()
    orig_mark_draining = router.mark_draining

    def mark_draining(rid):
        events.append(("mark_draining", rid))
        orig_mark_draining(rid)

    router.mark_draining = mark_draining
    pool = PoolManager(
        router,
        lambda rid, port: FakeHandle(events, rid),
        probe=probe,
        warmup_timeout_s=kw.pop("warmup_timeout_s", 2.0),
        warmup_poll_s=0.005,
        health_period_s=0.05,
        **kw,
    )
    return router, pool


WARM_STATS = {
    "buckets": [1, 2, 4], "n_compiles": 3, "queue_depth": 0,
    "batch_occupancy": 0.0, "jit_compiles": 3, "aot_compiles": 3,
}


def test_warmup_gates_routability():
    """A replica must NOT be routable until its probe reports every bucket
    shape AOT-compiled."""
    events, responses = [], []

    def probe(addr):
        if not responses:
            raise ConnectionRefusedError("not listening yet")
        return responses[0]

    router, pool = make_fake_pool(events, probe)
    pool.set_target(1)
    done = threading.Thread(target=pool.add_replica, daemon=True)
    done.start()
    time.sleep(0.05)
    assert router.n_routable() == 0  # not even listening
    responses.append({"buckets": [1, 2, 4], "n_compiles": 1})  # mid-compile
    time.sleep(0.05)
    assert router.n_routable() == 0  # up but NOT warm -> still not routable
    responses[0] = dict(WARM_STATS)
    done.join(timeout=2)
    assert not done.is_alive()
    assert router.n_routable() == 1
    rep = router.replicas()[0]
    assert rep.stats["jit_compiles"] == 3  # warm baseline recorded
    assert warmed_up(rep.stats)


def test_warmup_timeout_removes_replica():
    events = []
    router, pool = make_fake_pool(
        events, lambda addr: {"buckets": [1, 2], "n_compiles": 1},
        warmup_timeout_s=0.05,
    )
    pool.add_replica(wait=True)
    assert router.replicas() == []
    assert ("kill", 0) in events  # the stuck process was put down


def test_drain_stop_marks_draining_before_sigterm():
    """The drain-before-exit ordering: the router stops routing to the
    replica BEFORE the process gets SIGTERM, and the replica leaves the
    router only after it exits."""
    events = []
    router, pool = make_fake_pool(events, lambda addr: dict(WARM_STATS))
    rep = pool.add_replica(wait=True)
    assert router.n_routable() == 1
    assert pool.drain_stop(rep.id, wait=True)
    assert router.get_replica(rep.id) is None  # removed after exit
    lifecycle = [e for e in events if e[0] in ("mark_draining", "terminate")]
    assert lifecycle == [("mark_draining", rep.id), ("terminate", rep.id)]


def test_dead_replica_is_replaced_to_target():
    events = []
    router, pool = make_fake_pool(events, lambda addr: dict(WARM_STATS))
    pool.set_target(2)
    r0 = pool.add_replica(wait=True)
    pool.add_replica(wait=True)
    assert router.n_routable() == 2
    r0.proc._rc = -9  # SIGKILLed out-of-band
    pool.health_check()
    assert router.get_replica(r0.id) is None
    pool._maintain_target()  # the supervisor's replacement pass
    time.sleep(0.3)  # background warm-up of the replacement
    assert router.n_routable() == 2
    assert {r.id for r in router.replicas()} == {1, 2}  # fresh id spawned


def test_health_probe_failures_mark_dead_after_n():
    events, fail = [], {"on": False}

    def probe(addr):
        if fail["on"]:
            raise ConnectionRefusedError("down")
        return dict(WARM_STATS)

    router, pool = make_fake_pool(events, probe, health_fails=3)
    rep = pool.add_replica(wait=True)
    fail["on"] = True
    pool.health_check()
    pool.health_check()
    assert router.get_replica(rep.id) is not None  # 2 < HEALTH_FAILS
    pool.health_check()
    assert router.get_replica(rep.id) is None


# -- router dispatch over fake socket replicas -------------------------------

class FakeReplicaServer:
    """A real localhost socket speaking the serve framing, with a
    scripted responder (return bytes, or None to close the connection —
    the crashed-replica shape)."""

    def __init__(self, responder):
        self.responder = responder
        self.listener = protocol.open_listener("127.0.0.1", 0)
        self.port = self.listener.getsockname()[1]
        self.requests = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._accept, daemon=True)
        self._t.start()

    def _accept(self):
        self.listener.settimeout(0.05)
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

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
                resp = self.responder(payload)
                if resp is None:
                    return  # slam the connection shut mid-request
                try:
                    protocol.send_frame(conn, resp)
                except OSError:
                    return

    def close(self):
        self._stop.set()
        self.listener.close()


def _router_over(servers) -> Router:
    router = Router(request_timeout_s=5.0)
    for srv in servers:
        rep = router.add_replica("127.0.0.1", srv.port)
        router.mark_routable(rep.id)
    return router


def test_backpressure_passthrough_verbatim():
    """When every replica rejects with queue_full, the client receives a
    replica's retry-after rejection VERBATIM — the router must not queue
    the request itself."""
    rejection = json.dumps(
        {"error": "queue_full", "retry_after_ms": 123.4}
    ).encode()
    servers = [FakeReplicaServer(lambda p: rejection) for _ in range(2)]
    try:
        router = _router_over(servers)
        t0 = time.perf_counter()
        resp = router.dispatch(b"fake-image-payload")
        elapsed = time.perf_counter() - t0
        assert resp == rejection  # byte-for-byte the admission.py shape
        assert elapsed < 1.0  # rejected immediately, never queued/waited
        # every replica was offered the request before giving up
        assert all(srv.requests == 1 for srv in servers)
        snap = router.stats()
        assert snap["rejected"] == 1 and snap["requests"] == 0
    finally:
        for srv in servers:
            srv.close()


def test_reroute_on_replica_failure_is_idempotent():
    """A replica dying mid-request reroutes the SAME payload to the next
    replica; the client sees one success, the router records the reroute
    and stops routing to the dead replica."""
    seen = []
    ok = json.dumps({"pred": 7, "topk": [7], "logits": [0.0]}).encode()

    def good(payload):
        seen.append(payload)
        return ok

    dead = FakeReplicaServer(lambda p: None)  # closes on every request
    alive = FakeReplicaServer(good)
    try:
        router = _router_over([dead, alive])
        dead_rep, alive_rep = router.replicas()
        # bias the pick toward the dead replica so the reroute must happen
        alive_rep.stats = {"queue_depth": 5, "batch_occupancy": 1.0}
        alive_rep.ewma_ms = dead_rep.ewma_ms = 10.0
        payload = b"idempotent-request"
        resp = router.dispatch(payload)
        assert resp == ok
        assert seen == [payload]  # the same bytes arrived once, rerouted
        snap = router.stats()
        assert snap["rerouted"] == 1 and snap["replica_failures"] == 1
        assert snap["requests"] == 1
        assert not router.get_replica(dead_rep.id).routable
    finally:
        dead.close()
        alive.close()


def test_all_dead_returns_no_routable_error():
    dead = FakeReplicaServer(lambda p: None)
    try:
        router = _router_over([dead])
        resp = json.loads(router.dispatch(b"x"))
        assert resp["error"] == "no_routable_replicas"
        assert resp["retry_after_ms"] > 0
    finally:
        dead.close()


def test_router_serve_forwards_and_answers_stats():
    """End-to-end through the router's own accept loop: a data frame is
    forwarded to a replica, a stats control frame is answered by the
    router itself."""
    ok = json.dumps({"pred": 3, "topk": [3], "logits": [1.0]}).encode()
    srv = FakeReplicaServer(lambda p: ok)
    router = _router_over([srv])
    listener = protocol.open_listener("127.0.0.1", 0)
    port = listener.getsockname()[1]
    stop = threading.Event()
    t = threading.Thread(
        target=router.serve, args=(listener, stop.is_set),
        kwargs=dict(poll_s=0.05), daemon=True,
    )
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
            protocol.send_frame(conn, b"an-image")
            assert protocol.recv_frame(conn) == ok
            protocol.send_frame(conn, protocol.ctrl_request("stats"))
            stats = json.loads(protocol.recv_frame(conn))
        assert stats["replicas"] == 1 and stats["requests"] == 1
        assert stats["per_replica"][0]["requests"] == 1
    finally:
        stop.set()
        t.join(timeout=5)
        srv.close()


# -- autoscaler hysteresis math (pure) ---------------------------------------

def _policy(**kw):
    defaults = dict(
        p99_target_ms=100.0, queue_high=10, queue_low=1,
        scale_down_frac=0.5, breach_n=3, cooldown_s=10.0,
        min_replicas=1, max_replicas=4,
    )
    defaults.update(kw)
    return AutoscalePolicy(**defaults)


def _hot(n=1):
    return Observation(p99_ms=500.0, queue_depth=0, n_replicas=n)


def _calm(n=2):
    return Observation(p99_ms=10.0, queue_depth=0, n_replicas=n)


def _mid(n=2):
    return Observation(p99_ms=80.0, queue_depth=0, n_replicas=n)


def test_autoscale_needs_consecutive_breaches():
    p = _policy()
    assert p.decide(0.0, _hot()) == 0
    assert p.decide(1.0, _hot()) == 0
    assert p.decide(2.0, _hot()) == +1  # third consecutive breach
    # queue watermark alone also breaches
    p = _policy()
    q = Observation(p99_ms=10.0, queue_depth=50, n_replicas=1)
    assert [p.decide(float(t), q) for t in range(3)] == [0, 0, +1]


def test_autoscale_streak_resets_on_calm_window():
    p = _policy()
    p.decide(0.0, _hot())
    p.decide(1.0, _hot())
    p.decide(2.0, _mid(1))  # neither hot nor calm: both streaks reset
    assert p.decide(3.0, _hot()) == 0
    assert p.decide(4.0, _hot()) == 0
    assert p.decide(5.0, _hot()) == +1


def test_autoscale_cooldown_blocks_consecutive_actions():
    p = _policy(breach_n=1, cooldown_s=10.0)
    assert p.decide(0.0, _hot(1)) == +1
    assert p.decide(1.0, _hot(2)) == 0  # evidence real but inside cooldown
    assert p.decide(9.9, _hot(2)) == 0
    assert p.decide(11.0, _hot(2)) == +1  # cooldown expired


def test_autoscale_scale_down_and_clamps():
    p = _policy(breach_n=2, cooldown_s=0.1)
    assert p.decide(0.0, _calm(3)) == 0
    assert p.decide(1.0, _calm(3)) == -1
    # at the min budget, calm windows never go below
    p = _policy(breach_n=1, cooldown_s=0.0)
    assert p.decide(0.0, _calm(1)) == 0
    # at the max budget, hot windows never go above
    assert p.decide(1.0, _hot(4)) == 0


def test_autoscale_down_requires_both_calm_signals():
    p = _policy(breach_n=1, cooldown_s=0.0)
    # p99 calm but queue above the low watermark -> hold
    assert p.decide(0.0, Observation(p99_ms=10.0, queue_depth=5,
                                     n_replicas=2)) == 0
    # p99 at 0.6x target (not under scale_down_frac=0.5) -> hold
    assert p.decide(1.0, Observation(p99_ms=60.0, queue_depth=0,
                                     n_replicas=2)) == 0


def test_autoscale_validation():
    with pytest.raises(ValueError, match="SCALE_DOWN_FRAC"):
        _policy(scale_down_frac=1.5)
    with pytest.raises(ValueError, match="MIN_REPLICAS"):
        _policy(min_replicas=5, max_replicas=2)


def test_autoscaler_step_acts_through_pool():
    """The loop wiring: a hot router window scales the pool target up."""

    class FakePool:
        target_size = 1

        def scale_to(self, n, wait=True):
            self.target_size = n
            return n

    router = Router()
    now = time.perf_counter()
    with router._lock:
        router._recent = [(now, 0.5, None)] * 50  # 500 ms, fresh, untraced
    pool = FakePool()
    scaler = Autoscaler(
        router, pool,
        _policy(breach_n=2, cooldown_s=0.0), eval_period_s=5.0,
    )
    assert scaler.step(0.0) == 0
    assert scaler.step(1.0) == +1
    assert pool.target_size == 2


# -- fleet.* telemetry schema -------------------------------------------------

def test_fleet_kinds_declared_and_records_validate(tmp_path):
    """The fleet.* record kinds are declared in telemetry/schema.py and
    every record the router/pool/autoscaler emit validates against them
    (the dynamic half of tools/check_telemetry_schema.py's static gate)."""
    from distribuuuu_tpu_torch.telemetry.spans import close_telemetry, setup_telemetry

    for kind in ("fleet.stats", "fleet.replica", "fleet.scale"):
        assert kind in schema.KINDS
    router = Router()
    rep = router.add_replica("127.0.0.1", 1001)
    router.mark_routable(rep.id)
    path = setup_telemetry(str(tmp_path), rank=0)
    try:
        router.emit_telemetry()
        from distribuuuu_tpu_torch.telemetry import spans

        spans.emit_event(
            "fleet.scale", action="scale_up", reason="test",
            n_before=1, n_after=2,
        )
    finally:
        close_telemetry()
    kinds_seen = set()
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            schema.validate_record(rec)  # raises on undeclared/missing
            kinds_seen.add(rec["kind"])
    assert {"fleet.stats", "fleet.replica", "fleet.scale"} <= kinds_seen


# --------------------------------------------------- router length classes

def test_router_classifies_generate_frames():
    router = Router(long_prompt_threshold=8, short_p99_slo_ms=50.0,
                    long_p99_slo_ms=500.0)
    classify = router._classify_payload
    assert classify(
        protocol.ctrl_request("generate", tokens=list(range(10)))
    ) == "long"
    assert classify(
        protocol.ctrl_request("generate", tokens=[1, 2, 3])
    ) == "short"
    # text prompts count utf-8 bytes (the byte tokenizer's 1:1 identity)
    assert classify(
        protocol.ctrl_request("generate", text="x" * 9)
    ) == "long"
    assert classify(protocol.ctrl_request("generate", text="ab")) == "short"
    # non-generate ctrl frames and image payloads never classify
    assert classify(protocol.ctrl_request("stats")) is None
    assert classify(b"\xff\xd8rawjpegbytes") is None
    # classification off → everything is unclassified
    assert Router()._classify_payload(
        protocol.ctrl_request("generate", tokens=list(range(10)))
    ) is None


def test_router_per_class_stats_and_slo_rows():
    """Observed per-class latencies surface BOTH as a length_classes
    stats section and as `length:*` rows in the windowed models dict —
    the exact shape the slo-breach rule scans for targeted rows."""
    router = Router(long_prompt_threshold=8, short_p99_slo_ms=50.0,
                    long_p99_slo_ms=500.0)
    rep = router.add_replica("127.0.0.1", 1)
    router.mark_routable(rep.id)
    for _ in range(5):
        router._observe(rep, 0.010, length_class="short")
    router._observe(rep, 0.300, length_class="long")
    router._count_rejected(None, length_class="long")
    win = router.window_stats(60.0)
    assert win["models"]["length:short"]["samples"] == 5
    assert win["models"]["length:short"]["target_ms"] == 50.0
    assert win["models"]["length:long"]["target_ms"] == 500.0
    assert win["models"]["length:long"]["p99_ms"] >= 300.0
    snap = router.stats()
    assert snap["long_prompt_threshold"] == 8
    lc = snap["length_classes"]
    assert lc["short"]["requests"] == 5 and lc["short"]["rejected"] == 0
    assert lc["long"]["requests"] == 1 and lc["long"]["rejected"] == 1
    assert lc["long"]["p99_slo_ms"] == 500.0
    # an unclassified router surfaces neither section
    assert "length_classes" not in Router().stats()


def test_router_busy_passthrough_counts_long_rejection():
    """A long generate stream rejected by every replica passes the
    replica's queue_full frame through verbatim AND lands in the long
    class's rejected count — the campaign's backpressure evidence."""
    rep_listener = protocol.open_listener("127.0.0.1", 0)
    rep_port = rep_listener.getsockname()[1]

    def busy_replica():
        conn, _ = rep_listener.accept()
        with conn:
            protocol.recv_frame(conn)
            protocol.send_frame(conn, json.dumps(
                {"error": "queue_full", "retry_after_ms": 77.0}
            ).encode())

    rt = threading.Thread(target=busy_replica, daemon=True)
    rt.start()
    router = Router(request_timeout_s=10.0, long_prompt_threshold=8)
    rep = router.add_replica("127.0.0.1", rep_port)
    router.mark_routable(rep.id)
    listener = protocol.open_listener("127.0.0.1", 0)
    port = listener.getsockname()[1]
    stop = threading.Event()
    t = threading.Thread(
        target=router.serve, args=(listener, stop.is_set), daemon=True
    )
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
            protocol.send_frame(c, protocol.ctrl_request(
                "generate", tokens=list(range(20))
            ))
            resp = json.loads(protocol.recv_frame(c))
        assert resp == {"error": "queue_full", "retry_after_ms": 77.0}
        assert router.stats()["length_classes"]["long"]["rejected"] == 1
    finally:
        stop.set()
        t.join(5)
        rep_listener.close()


def test_length_class_telemetry_schema(tmp_path):
    """fleet.length_class records land schema-valid in the span sink."""
    import glob

    from distribuuuu_tpu_torch import telemetry

    tcfg.OUT_DIR = str(tmp_path)
    telemetry.setup_from_cfg(tcfg, rank=0)
    try:
        router = Router(long_prompt_threshold=8, long_p99_slo_ms=500.0)
        rep = router.add_replica("127.0.0.1", 1)
        router.mark_routable(rep.id)
        router._observe(rep, 0.010, length_class="short")
        router._observe(rep, 0.200, length_class="long")
        router.emit_telemetry()
    finally:
        from distribuuuu_tpu_torch.telemetry import spans

        spans.close_telemetry()
    recs = []
    for p in glob.glob(str(tmp_path / "telemetry" / "rank*.jsonl")):
        with open(p) as f:
            recs.extend(json.loads(line) for line in f)
    lrecs = {r["length_class"]: r for r in recs
             if r.get("kind") == "fleet.length_class"}
    assert set(lrecs) == {"short", "long"}
    assert lrecs["long"]["threshold"] == 8
    assert lrecs["short"]["requests"] == 1
    for r in recs:
        schema.validate_record(r)


# -- the port's policy is JAX's ----------------------------------------------

def test_load_score_and_pick_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        fields = [dict(inflight=int(rng.integers(-1, 5)), queue_depth=int(rng.integers(-1, 9)),
                       occupancy=float(rng.uniform(-0.5, 1.5)),
                       ewma_ms=float(rng.choice([0.0, 0.05, rng.uniform(0, 50)])))
                  for _ in range(n)]
        mask = rng.random(n) < 0.2
        ours = [None if m else LoadSnapshot(**f) for f, m in zip(fields, mask)]
        theirs = [None if m else jrouter.LoadSnapshot(**f) for f, m in zip(fields, mask)]
        for a, b in zip(ours, theirs):
            if a is not None:
                assert load_score(a) == jrouter.load_score(b)
        rr = int(rng.integers(0, 7))
        assert pick_replica(ours, rr=rr) == jrouter.pick_replica(theirs, rr=rr)


# -- serve_net --fleet 2 on the CPU ---------------------------------------------

FLEET_OPTS = ["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
              "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "32",
              "SERVE.BUCKET_SIZES", "[1,2]", "SERVE.MAX_BATCH", "2",
              "SERVE.FLEET.AUTOSCALE", "False", "SERVE.FLEET.HEALTH_PERIOD_S", "0.2",
              "SERVE.FLEET.EMIT_INTERVAL_S", "0.1"]


def _ask(port: int, payload: bytes) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as c:
        protocol.send_frame(c, payload)
        return json.loads(protocol.recv_frame(c))


def _npy(img: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _wait(pred, timeout: float, what: str):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_fleet_two_cpu_replicas_end_to_end(tmp_path):
    """``serve_net --fleet 2`` (resnet18 at 32², the CPU): answers through
    the router equal one in-process engine's, a replica SIGKILLed under a
    burst loses no request, SIGTERM drains the fleet, and the router's rank
    0 and the replicas' ranks 1.. hold schema-valid records. (The
    replacement of the killed replica is the fake pool's test above and
    the card run's.)"""
    from distribuuuu_tpu_torch.config import merge_from_file
    from distribuuuu_tpu_torch.serve import engine_from_cfg
    from distribuuuu_tpu_torch.serve.fleet import free_port, probe_stats

    port = free_port()
    out = str(tmp_path / "fleet")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "distribuuuu_tpu_torch.serve_net", "--cfg",
           "config/resnet18.yaml", "--fleet", "2", *FLEET_OPTS, "SERVE.PORT", str(port),
           "OUT_DIR", out]
    router = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        # the reference engine, in this process, while the fleet warms
        merge_from_file("config/resnet18.yaml")
        tcfg.merge_from_list([*FLEET_OPTS[:14], "OUT_DIR", str(tmp_path / "ref")])
        ref = engine_from_cfg().start()
        transform = protocol.make_transform()
        imgs = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
        want = [ref.submit(transform(_npy(im))).result() for im in imgs]
        ref.drain()
        _wait(lambda: _stats(port), 180, "the router")
        got = [_ask(port, _npy(im)) for im in imgs]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["logits"], w, rtol=0, atol=1e-4 * np.abs(w).max())
        victim = _stats(port)["per_replica"][0]
        pid = probe_stats(("127.0.0.1", victim["port"]))["pid"]
        answers = []

        def burst():
            answers.extend(_ask(port, _npy(im)) for im in imgs for _ in range(2))

        t = threading.Thread(target=burst)
        t.start()
        os.kill(pid, 9)
        t.join(60)
        assert len(answers) == 12 and all("logits" in a for a in answers), answers
    finally:
        router.terminate()
        log = router.communicate(timeout=60)[0]
    assert router.returncode == 0, log[-3000:]
    assert "fleet drained; exiting" in log
    recs = {}
    for name in sorted(os.listdir(os.path.join(out, "telemetry"))):
        with open(os.path.join(out, "telemetry", name)) as f:
            recs[name] = [json.loads(line) for line in f]
    for rs in recs.values():
        for r in rs:
            schema.validate_record(r)
    kinds = {r["kind"] for r in recs["rank00000.jsonl"]}
    assert {"fleet.stats", "fleet.replica"} <= kinds
    assert {"rank00001.jsonl", "rank00002.jsonl"} <= set(recs)


def _stats(port: int):
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            protocol.send_frame(c, protocol.ctrl_request("stats"))
            return json.loads(protocol.recv_frame(c))
    except OSError:
        return None
