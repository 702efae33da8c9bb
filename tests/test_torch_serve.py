"""The port's serving path (distribuuuu_tpu_torch/serve) on the CPU:
engine logits equal the direct forward, padding rows change nothing, the
warmed shapes stay fixed under traffic, the JAX engine on the same
weights agrees, batch mode and the wire protocol work, and the entry
points refuse to run on the CPU unless asked to."""

from __future__ import annotations

import io
import json
import socket
import threading

import numpy as np
import pytest
import torch
from torch_port_util import jax_resnet, port_model, random_variables, reset_port_cfg

from distribuuuu_tpu.serve import protocol as jprotocol
from distribuuuu_tpu.serve.engine import Engine as JaxEngine
from distribuuuu_tpu.telemetry import tracectx
from distribuuuu_tpu_torch import serve_net
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.serve import (
    COMPILE_EVENTS,
    AdmissionController,
    Engine,
    EngineClosedError,
    QueueFullError,
    engine_from_cfg,
    protocol,
)

IM, NC = 32, 10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.fixture(scope="module")
def variables():
    model, shapes = jax_resnet("resnet50", NC, IM)
    return model, random_variables(shapes, seed=11)


@pytest.fixture(scope="module")
def engine(variables):
    eng = Engine(port_model("resnet50", variables[1]), IM, device=CPU, max_batch=4,
                 bucket_sizes=[1, 2, 4], max_wait_ms=200.0, max_queue=32)
    eng.start()
    yield eng
    eng.drain()


def _images(n, seed=0, size=IM):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8)


def _forward(model, images):
    with torch.inference_mode():
        return model(normalize_on_device(torch.from_numpy(images))).numpy()


def test_engine_logits_equal_direct_forward_and_shapes_stay_warm(engine):
    n_compiles, n_events = engine.n_compiles, len(COMPILE_EVENTS)
    assert n_compiles == 3 and engine.stats()["buckets"] == [1, 2, 4]
    images = _images(5, seed=1)
    got = np.stack([f.result(timeout=60) for f in [engine.submit(i) for i in images]])
    assert got.shape == (5, NC) and got.dtype == np.float32
    np.testing.assert_allclose(got, _forward(engine.model, images), rtol=1e-6, atol=1e-6)
    assert engine.n_compiles == n_compiles and len(COMPILE_EVENTS) == n_events
    assert engine.stats()["n_compiles"] == n_compiles


def test_padding_rows_change_nothing(engine):
    images = _images(3, seed=2)
    got = np.stack([f.result(timeout=60) for f in [engine.submit(i) for i in images]])
    zero = np.zeros((4, IM, IM, 3), np.uint8)
    zero[:3] = images
    garbage = zero.copy()
    garbage[3] = 255
    a, b = _forward(engine.model, zero), _forward(engine.model, garbage)
    np.testing.assert_array_equal(a[:3], b[:3])  # bitwise
    np.testing.assert_allclose(got, a[:3], rtol=1e-6, atol=1e-6)


def test_jax_engine_on_same_weights_agrees(variables, engine):
    """Same weights, same uint8 requests: the JAX engine (XLA on the CPU)
    and the port's engine agree within rtol=1e-4, atol=1e-4 (f32; the two
    sum the convs in different orders)."""
    model, v = variables
    images = _images(5, seed=3)
    jeng = JaxEngine(model, v, IM, max_batch=4, bucket_sizes=[4], max_wait_ms=200.0,
                     max_queue=32, input_dtype=np.uint8)
    with jeng:
        ref = np.stack([f.result(timeout=120) for f in [jeng.submit(i) for i in images]])
    got = np.stack([f.result(timeout=60) for f in [engine.submit(i) for i in images]])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_run_batch_roundtrips_npy(engine, tmp_path):
    images = _images(6, seed=4)
    np.save(tmp_path / "in.npy", images)
    assert protocol.run_batch(engine, str(tmp_path / "in.npy"), str(tmp_path / "out.npy")) == 6
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (6, NC) and out.dtype == np.float32
    np.testing.assert_allclose(out, _forward(engine.model, images), rtol=1e-6, atol=1e-6)


def test_submit_validates_shape_and_dtype(engine):
    with pytest.raises(ValueError, match="engine's input"):
        engine.submit(np.zeros((IM, IM, 3), np.float32))
    with pytest.raises(ValueError, match="engine's input"):
        engine.submit(np.zeros((IM + 1, IM, 3), np.uint8))


@pytest.mark.parametrize("platform", ["auto", "cuda"])
def test_entry_point_refuses_cpu_unless_asked(platform):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for machines without it")
    tcfg.merge_from_list(["DEVICE.PLATFORM", platform])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        engine_from_cfg()


def test_unported_serving_features_raise(tmp_path):
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "SERVE.QUANTIZE", "bf16"])
    with pytest.raises(NotImplementedError, match="Serving quantization"):
        engine_from_cfg()
    with pytest.raises(NotImplementedError, match="Serving fleet"):
        serve_net.main(["--cfg", "config/resnet50.yaml", "--fleet", "2"])
    tcfg.defrost()
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):  # TP decode
        serve_net.main(["--cfg", "config/gpt_nano.yaml", "MESH.MODEL", "2",
                        "OUT_DIR", str(tmp_path)])


def test_admission_and_drain_before_start(variables):
    adm = AdmissionController(max_queue=1)
    adm.admit(0, 5.0)
    with pytest.raises(QueueFullError):
        adm.admit(1, 5.0)
    eng = Engine(port_model("resnet18", random_variables(jax_resnet("resnet18")[1])),
                 IM, device=CPU, max_batch=1, max_queue=4)
    fut = eng.submit(_images(1)[0])
    eng.drain()
    with pytest.raises(EngineClosedError):
        fut.result(timeout=5)
    with pytest.raises(EngineClosedError):
        eng.submit(_images(1)[0])


def _ask(sock, payload: bytes) -> dict:
    jprotocol.send_frame(sock, payload)
    return json.loads(jprotocol.recv_frame(sock))


def test_wire_protocol_is_byte_compatible(variables):
    """A client speaking the JAX package's wire format (frames, ctrl ops,
    model and trace envelopes) is answered by the port's server."""
    tcfg.merge_from_list(["TRAIN.IM_SIZE", IM, "TEST.IM_SIZE", IM])
    eng = Engine(port_model("resnet50", variables[1]), IM, device=CPU, max_batch=2,
                 max_wait_ms=1.0, max_queue=8).start()
    listener = protocol.open_listener("127.0.0.1", 0)
    stop = threading.Event()
    t = threading.Thread(target=protocol.serve_forever,
                         args=(eng, listener, stop.is_set, 3), daemon=True)
    t.start()
    try:
        with socket.create_connection(listener.getsockname()[:2], timeout=60) as s:
            stats = _ask(s, jprotocol.ctrl_request("stats"))
            assert stats["n_compiles"] == stats["aot_compiles"] == 2
            assert stats["jit_compiles"] == 0 and stats["accepting"] is True
            assert _ask(s, jprotocol.ctrl_request("generate"))["error"] == "not_a_generation_replica"
            raw = _images(1, seed=5, size=40)[0]
            buf = io.BytesIO()
            np.save(buf, raw)
            bare = _ask(s, buf.getvalue())
            assert len(bare["logits"]) == NC and len(bare["topk"]) == 3
            ctx = tracectx.TraceContext(tracectx.new_trace_id())
            wrapped = tracectx.wrap_payload(ctx, jprotocol.model_envelope("resnet50", buf.getvalue()))
            assert _ask(s, wrapped)["logits"] == bare["logits"]
            assert _ask(s, tracectx.TRACE_MAGIC + b"\x00")["error"] == "bad_trace_envelope"
    finally:
        stop.set()
        t.join(timeout=30)
    assert not eng._admission.is_open  # serve_forever drained the engine


def test_serve_net_batch_mode(tmp_path):
    images = _images(3, seed=6)
    np.save(tmp_path / "in.npy", images)
    serve_net.main([
        "--cfg", "config/resnet18.yaml", "--batch-input", str(tmp_path / "in.npy"),
        "--batch-output", str(tmp_path / "out.npy"), "DEVICE.PLATFORM", "cpu",
        "DEVICE.COMPUTE_DTYPE", "float32", "MODEL.NUM_CLASSES", str(NC),
        "TRAIN.IM_SIZE", str(IM), "SERVE.MAX_BATCH", "2", "OUT_DIR", str(tmp_path),
    ])
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (3, NC) and np.isfinite(out).all()
