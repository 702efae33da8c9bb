"""Request traces in the port (distribuuuu_tpu_torch/telemetry/tracectx.py,
serve/protocol.py, lm/) against the JAX package's, and the LM engine's
records.

* ``should_sample`` is JAX's on 1000 ids at five rates; the payload
  envelope is byte-equal to JAX's ``wrap_payload`` both ways; the ctrl
  field decodes as JAX's; a generate ctrl frame, traced or not, is
  byte-equal to the JAX client's.
* A traced request through the port's replica, client edge to engine,
  gives one connected ``trace.span`` tree; a traced image request lands
  the replica's ``replica.handle`` span.
* The port's ``GenerateEngine`` and the JAX one serve the same greedy
  requests with telemetry on and write the same counts of ``gen.admit``,
  ``gen.prefill``, ``gen.decode`` and ``gen.retire`` and the same
  ``lm.tokens`` ``new_tokens``; every record validates.
"""

from __future__ import annotations

import collections
import io
import json
import socket
import threading

import numpy as np
import pytest
import torch
from torch_port_util import few_threads, jax_gpt, port_gpt, random_variables, reset_port_cfg

from distribuuuu_tpu.lm import generate as jgen
from distribuuuu_tpu.lm import service as jservice
from distribuuuu_tpu.serve import protocol as jprotocol
from distribuuuu_tpu.telemetry import spans as jspans
from distribuuuu_tpu.telemetry import tracectx as jtrace
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.lm import generate as tgen
from distribuuuu_tpu_torch.lm import service as lm_service
from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.telemetry import schema, spans, tracectx

CPU = torch.device("cpu")
ENGINE = dict(prompt_len=8, max_new_tokens=6, batch_tiles=[1, 2], cache_tiles=[16, 32],
              eos_id=-1)
PROMPTS = [[5, 9, 2], [7, 1, 3, 4, 8, 2, 6, 0], [11, 12, 13, 14, 15], [200]]


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    yield from few_threads()
    spans.close_telemetry()
    reset_port_cfg()


@pytest.fixture(scope="module")
def gpt():
    jmodel, shapes = jax_gpt(seq_len=32)
    return jmodel, random_variables(shapes, seed=5)


def _read(path):
    spans.flush()  # the writer thread's queue into the open sink
    return [json.loads(ln) for ln in open(path).read().splitlines()]


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_sampling_agrees_with_jax(rate):
    rng = np.random.default_rng(0)
    ids = [rng.bytes(8).hex() for _ in range(1000)]
    ours = [tracectx.should_sample(t, rate) for t in ids]
    assert ours == [jtrace.should_sample(t, rate) for t in ids]
    if 0 < rate < 1:
        assert abs(sum(ours) / len(ids) - rate) < 0.06
    assert tracectx.open_trace(0.0) is None


def test_envelope_is_byte_equal_to_jax_both_ways():
    ctx, jctx = (tracectx.TraceContext("aa" * 8, "span-1", 123.5),
                 jtrace.TraceContext("aa" * 8, "span-1", 123.5))
    wire = tracectx.wrap_payload(ctx, b"payload-bytes")
    assert wire == jtrace.wrap_payload(jctx, b"payload-bytes")
    assert tracectx.TRACE_MAGIC == jtrace.TRACE_MAGIC
    back, inner = tracectx.split_payload(jtrace.wrap_payload(jctx, b"x"))
    assert inner == b"x" and (back.trace_id, back.parent_span, back.origin) == \
        ("aa" * 8, "span-1", 123.5)
    jback, jinner = jtrace.split_payload(wire)
    assert jinner == b"payload-bytes" and jback.parent_span == "span-1"
    assert tracectx.wrap_payload(None, b"x") == b"x"
    assert tracectx.split_payload(b"x") == (None, b"x")
    menv = jprotocol.model_envelope("m", b"img")
    assert tracectx.split_payload(menv) == (None, menv)
    for torn in (wire[:10], wire[:12], tracectx.TRACE_MAGIC + b"\xff\xff"):
        with pytest.raises(ValueError, match="torn trace envelope"):
            tracectx.split_payload(torn)


@pytest.mark.parametrize("obj", [None, "nope", {}, {"id": 3}, {"id": "", "parent": "p"},
                                 {"id": "ab" * 8, "parent": 7, "origin": "bad"},
                                 {"id": "ab" * 8, "parent": "p", "origin": 2.5}])
def test_ctrl_fields_decode_as_jax(obj):
    ours, ref = tracectx.from_fields(obj), jtrace.from_fields(obj)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert (ours.trace_id, ours.parent_span, ours.origin) == \
            (ref.trace_id, ref.parent_span, ref.origin)
        assert tracectx.to_fields(ours) == jtrace.to_fields(ref)


def _first_frame(client, **kw) -> bytes:
    """The first frame ``client`` (a generate_request) sends, answered by
    one done frame."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    got = {}

    def serve():
        conn, _ = lst.accept()
        with conn:
            got["frame"] = protocol.recv_frame(conn)
            protocol.send_frame(conn, json.dumps({"stream": "done", "tokens": []}).encode())

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    list(client("127.0.0.1", lst.getsockname()[1], tokens=[1, 2], max_new_tokens=3, **kw))
    t.join(10)
    lst.close()
    return got["frame"]


def test_generate_ctrl_frames_are_byte_equal_to_the_jax_client(monkeypatch):
    assert _first_frame(lm_service.generate_request) == \
        _first_frame(jservice.generate_request)
    # a traced frame: the same context, the same edge span id
    monkeypatch.setattr(tracectx, "new_span_id", lambda: "edge-1")
    monkeypatch.setattr(jtrace, "new_span_id", lambda: "edge-1")
    ours = _first_frame(lm_service.generate_request,
                        trace=tracectx.TraceContext("cd" * 8, "", 5.0))
    ref = _first_frame(jservice.generate_request, trace=jtrace.TraceContext("cd" * 8, "", 5.0))
    assert ours == ref and b'"trace"' in ours


def _serve(engine):
    listener = protocol.open_listener("127.0.0.1", 0)
    stop = threading.Event()
    t = threading.Thread(target=protocol.serve_forever, args=(engine, listener, stop.is_set),
                         daemon=True)
    t.start()
    return listener.getsockname()[1], stop, t


def test_a_traced_request_is_one_connected_tree(gpt, tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    eng = tgen.GenerateEngine(port_gpt(*gpt), device=CPU, **ENGINE).start()
    port, stop, t = _serve(eng)
    try:
        frames = list(lm_service.generate_request("127.0.0.1", port, tokens=PROMPTS[0],
                                                  max_new_tokens=4, trace_sample=1.0))
        plain = list(lm_service.generate_request("127.0.0.1", port, tokens=PROMPTS[0],
                                                 max_new_tokens=4))
    finally:
        stop.set()
        t.join(30)
    tid = frames[-1]["trace_id"]
    assert all(f["trace_id"] == tid for f in frames) and "trace_id" not in plain[-1]
    assert [f.get("token") for f in frames] == [f.get("token") for f in plain]
    recs = _read(path)
    for r in recs:
        schema.validate_record(r)
    tree = [r for r in recs if r["kind"] == "trace.span"]
    assert {r["trace"] for r in tree} == {tid}
    ids = {r["span"] for r in tree}
    roots = [r for r in tree if r["parent"] == ""]
    assert [r["name"] for r in roots] == ["client.request"]
    assert all(r["parent"] in ids for r in tree if r["parent"])
    names = collections.Counter(r["name"] for r in tree)
    assert names["engine.request"] == names["queue_wait"] == names["prefill"] == 1
    assert names["decode_step"] == 3  # 4 tokens: the prefill's, then 3 steps
    engine_req = next(r for r in tree if r["name"] == "engine.request")
    assert engine_req["parent"] == roots[0]["span"]


def test_a_traced_image_request_lands_the_replica_span(tmp_path):
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.serve.engine import Engine

    tcfg.merge_from_list(["MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10,
                          "DEVICE.COMPUTE_DTYPE", "float32", "TRAIN.IM_SIZE", 32,
                          "TEST.IM_SIZE", 32])
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    eng = Engine(trainer.build_model_from_cfg(), 32, device=CPU, max_batch=1,
                 max_wait_ms=1.0).start()
    port, stop, t = _serve(eng)
    buf = io.BytesIO()
    np.save(buf, np.zeros((32, 32, 3), np.uint8))
    ctx = tracectx.TraceContext("ef" * 8, "edge", 1.0)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            protocol.send_frame(s, tracectx.wrap_payload(ctx, buf.getvalue()))
            traced = json.loads(protocol.recv_frame(s))
            protocol.send_frame(s, buf.getvalue())
            plain = json.loads(protocol.recv_frame(s))
    finally:
        stop.set()
        t.join(30)
    assert traced["logits"] == plain["logits"]
    (rec,) = [r for r in _read(path) if r["kind"] == "trace.span"]
    assert (rec["name"], rec["trace"], rec["parent"], rec["ok"]) == \
        ("replica.handle", "ef" * 8, "edge", True)


def test_lm_records_match_the_jax_engine(gpt, tmp_path):
    """Both engines take the same requests before they start (one
    admission order), greedy, with telemetry on."""
    from distribuuuu_tpu.telemetry import costmodel as jcost
    from distribuuuu_tpu.telemetry import registry as jregistry

    def fresh():  # the JAX ledger counts a label once a process: as a new one
        jcost.reset()
        jregistry.get_registry().reset()

    spans.setup_telemetry(str(tmp_path / "port"), rank=0)
    fresh()
    jspans.setup_telemetry(str(tmp_path / "jax"), rank=0)
    try:
        outs = {}
        for name, make in (("port", lambda: tgen.GenerateEngine(port_gpt(*gpt), device=CPU,
                                                                **ENGINE)),
                           ("jax", lambda: jgen.GenerateEngine(gpt[0], gpt[1], **ENGINE))):
            eng = make()
            streams = [eng.submit(p) for p in PROMPTS]
            eng.start()
            outs[name] = [s.result(timeout=120) for s in streams]
            eng.drain()
    finally:
        jspans.close_telemetry()
        spans.close_telemetry()
        fresh()
    assert outs["port"] == outs["jax"]
    counts = {}
    for name in ("port", "jax"):
        recs = _read(tmp_path / name / "rank00000.jsonl")
        if name == "port":
            for r in recs:
                schema.validate_record(r)
        c = collections.Counter(r["kind"] for r in recs)
        (tokens,) = [r for r in recs if r["kind"] == "lm.tokens"]
        counts[name] = ({k: c[k] for k in ("gen.admit", "gen.prefill", "gen.decode",
                                            "gen.retire")}, tokens["new_tokens"],
                        tokens["decode_steps"])
    assert counts["port"] == counts["jax"]
    assert counts["port"][1] == sum(len(o) for o in outs["port"]) == len(PROMPTS) * 6
