"""Length-prefixed socket frontend + one-shot batch mode (counterpart of
distribuuuu_tpu/serve/protocol.py, byte-compatible on the wire).

Every frame is a 4-byte big-endian payload length followed by the payload.
Request payloads, auto-detected:

* ``.npy`` bytes holding an (H, W, 3) uint8 image, or a
  ``(TRAIN.IM_SIZE, TRAIN.IM_SIZE, 3)`` float32 array taken as already
  val-transformed;
* anything else — an encoded image file (PIL-decodable);
* a control frame (``CTRL_MAGIC`` + JSON): ``op="stats"`` answers the
  engine's stats; ``op="generate"`` streams token frames and a done frame
  from an LM engine (``lm/service.handle_generate``) and answers
  ``not_a_generation_replica`` from an image engine;
* a model envelope (``MODEL_MAGIC``) is stripped — this replica is the
  model; a trace envelope (``telemetry/tracectx.TRACE_MAGIC``) is
  stripped too, or refused as ``bad_trace_envelope`` when torn. Its
  context is kept: a traced image request lands a ``replica.handle``
  ``trace.span`` in this process's sink, and a generate ctrl frame's
  ``"trace"`` field reaches the LM engine (``lm/service.py``).

Response payload: JSON — ``{"pred", "topk", "logits"}`` on success;
``{"error": ..., "retry_after_ms"?}`` on rejection/failure.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import sys
import threading
import time

import numpy as np

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.serve.admission import EngineClosedError, QueueFullError
from distribuuuu_tpu_torch.telemetry import registry as telemetry_registry
from distribuuuu_tpu_torch.telemetry import tracectx

_NPY_MAGIC = b"\x93NUMPY"
MAX_FRAME = 64 << 20  # refuse absurd frames before allocating for them
CTRL_MAGIC = b"\x00DTPUCTL1"
MODEL_MAGIC = b"\x00DTPUMDL1"


def ctrl_request(op: str, **fields) -> bytes:
    """Encode a control request payload (send it with ``send_frame``)."""
    return CTRL_MAGIC + json.dumps({"op": op, **fields}).encode()


def parse_ctrl(payload: bytes) -> dict | None:
    """The decoded control request, or None for a data (image) payload."""
    if not payload.startswith(CTRL_MAGIC):
        return None
    return json.loads(payload[len(CTRL_MAGIC):])


def model_envelope(model: str, payload: bytes) -> bytes:
    """Wrap a request payload with the model id it must route to."""
    mid = model.encode("utf-8")
    if not 0 < len(mid) < 256:
        raise ValueError(f"model id must be 1..255 utf-8 bytes, got {model!r}")
    return MODEL_MAGIC + bytes([len(mid)]) + mid + payload


def split_model_envelope(payload: bytes) -> tuple[str | None, bytes]:
    """(model_id, inner_payload) for an enveloped payload; (None, payload)
    for a bare one."""
    if not payload.startswith(MODEL_MAGIC):
        return None, payload
    n = payload[len(MODEL_MAGIC)]
    start = len(MODEL_MAGIC) + 1
    mid = payload[start:start + n]
    if len(mid) != n:
        raise ValueError("truncated model envelope")
    return mid.decode("utf-8"), payload[start + n:]


def replica_stats(engine) -> dict:
    """The answer to a ``stats`` control frame: the engine's view plus the
    process's ``jit.compiles`` (graph captures, ``telemetry/runtime.py``,
    counted while the telemetry sink is open) and the engine's warmed
    shapes as ``aot_compiles``, under the JAX replica's keys."""
    out = engine.stats()
    out.update(
        pid=os.getpid(),
        accepting=engine._admission.is_open,
        jit_compiles=int(telemetry_registry.get_registry().counter("jit.compiles").value),
        aot_compiles=int(engine.n_compiles),
    )
    return out


# -- framing ----------------------------------------------------------------

def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf += chunk
    return buf


def recv_frame(sock: socket.socket) -> bytes | None:
    """One frame's payload, or None on clean EOF."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds MAX_FRAME={MAX_FRAME}")
    return _recv_exact(sock, n)


# -- request decoding -------------------------------------------------------

def make_transform():
    """The val pipeline as a payload → engine-input function, from the cfg."""
    from PIL import Image

    from distribuuuu_tpu_torch.data.transforms import val_transform

    resize, crop = cfg.TEST.IM_SIZE, cfg.TRAIN.IM_SIZE
    normalize = not cfg.DATA.DEVICE_NORMALIZE

    def transform(payload: bytes) -> np.ndarray:
        if payload[: len(_NPY_MAGIC)] == _NPY_MAGIC:
            arr = np.load(io.BytesIO(payload), allow_pickle=False)
            if arr.dtype == np.float32 and arr.shape == (crop, crop, 3):
                return arr  # pre-transformed: the engine's float input path
            if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
                raise ValueError(
                    f"npy request must be (H, W, 3) uint8 raw or "
                    f"({crop}, {crop}, 3) float32 pre-transformed, got "
                    f"{arr.shape} {arr.dtype}"
                )
            img = Image.fromarray(arr)
        else:
            img = Image.open(io.BytesIO(payload)).convert("RGB")
        return val_transform(img, resize, crop, normalize=normalize)

    return transform


# -- socket server ----------------------------------------------------------

def open_listener(host: str, port: int) -> socket.socket:
    """Bound+listening socket (port 0 ⇒ ephemeral)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    # a deep accept queue: under a burst of new connections (a stream a
    # connection) a full queue drops SYNs, and the client's retry backoff
    # (1 s, 3 s, ...) turns an overload into seconds of latency
    sock.listen(socket.SOMAXCONN)
    return sock


def _answer(engine, payload: bytes, transform, topk: int) -> dict:
    """The JSON response to one (envelope-stripped) payload."""
    ctrl = parse_ctrl(payload)
    if ctrl is not None:
        if ctrl.get("op") == "stats":
            return replica_stats(engine)
        if ctrl.get("op") == "generate":
            return {
                "error": "not_a_generation_replica",
                "detail": "this replica serves an image arch; "
                          "generate needs a gpt_* MODEL.ARCH",
            }
        return {"error": f"unknown control op {ctrl.get('op')!r}"}
    try:
        getattr(engine, "precheck", lambda: None)()
        logits = engine.submit(transform(payload)).result()
        order = np.argsort(logits)[::-1][: max(1, topk)]
        return {
            "pred": int(order[0]),
            "topk": [int(i) for i in order],
            "logits": [float(v) for v in logits],
        }
    except QueueFullError as e:
        return {"error": "queue_full", "retry_after_ms": round(e.retry_after_ms, 1)}
    except EngineClosedError:
        return {"error": "draining"}
    except Exception as e:  # noqa: BLE001 — per-request fault isolation
        return {"error": f"{type(e).__name__}: {e}"}


def _handle_conn(engine, conn: socket.socket, transform, topk: int) -> None:
    with conn:
        while True:
            try:
                payload = recv_frame(conn)
            except (OSError, ValueError):
                return
            if payload is None:
                return
            try:
                trace, payload = tracectx.split_payload(payload)
            except ValueError:
                resp = {"error": "bad_trace_envelope"}
            else:
                try:
                    _model, payload = split_model_envelope(payload)
                except (ValueError, IndexError):
                    resp = {"error": "bad_model_envelope"}
                else:
                    ctrl = parse_ctrl(payload)
                    if (ctrl is not None and ctrl.get("op") == "generate"
                            and hasattr(engine, "prompt_len")):
                        # the LM's streaming frames: one per token on this
                        # connection, a done frame last
                        from distribuuuu_tpu_torch.lm import service as lm_service

                        try:
                            lm_service.handle_generate(engine, ctrl,
                                                       lambda p: send_frame(conn, p))
                        except OSError:
                            return
                        continue
                    t_req = time.perf_counter()
                    resp = _answer(engine, payload, transform, topk)
                    if ctrl is None:
                        tracectx.emit_trace_span(trace, "replica.handle", t_req,
                                                 time.perf_counter() - t_req,
                                                 ok=("error" not in resp))
            try:
                send_frame(conn, json.dumps(resp).encode())
            except OSError:
                return


def serve_forever(engine, listener: socket.socket, should_stop, topk: int = 5,
                  poll_s: float = 0.25) -> None:
    """Accept loop: one handler thread per connection. Polls
    ``should_stop()`` between accepts; on stop it closes the listener,
    drains the engine and joins the handlers."""
    transform = make_transform()
    listener.settimeout(poll_s)
    handlers: list[threading.Thread] = []
    try:
        while not should_stop():
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            t = threading.Thread(
                target=_handle_conn, args=(engine, conn, transform, topk), daemon=True
            )
            t.start()
            handlers.append(t)
    finally:
        listener.close()
        engine.drain()
        # one 5 s grace for all handlers, not 5 s each: a fleet router holds
        # pooled connections open until the replica exits, so a handler may
        # sit in recv until then (the threads are daemons)
        deadline = time.perf_counter() + 5.0
        for t in handlers:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))


# -- batch mode -------------------------------------------------------------

def run_batch(engine, in_path: str, out_path: str) -> int:
    """One-shot batch mode: ``.npy`` images in, ``.npy`` float32 logits out
    ('-' = stdin/stdout). Input is (N, IM, IM, 3) in the engine's input
    dtype. Submits through admission and batching, waiting out the retry
    hint on backpressure. Returns N."""
    src = sys.stdin.buffer if in_path == "-" else in_path
    images = np.load(src, allow_pickle=False)
    if images.ndim != 4:
        raise ValueError(f"batch input must be (N, H, W, 3), got {images.shape}")
    futs = []
    for row in images:
        while True:
            try:
                futs.append(engine.submit(row))
                break
            except QueueFullError as e:  # back off as a client would
                time.sleep(e.retry_after_ms / 1e3)
    logits = np.stack([f.result() for f in futs]).astype(np.float32)
    if out_path == "-":
        np.save(sys.stdout.buffer, logits)
        sys.stdout.buffer.flush()
    else:
        np.save(out_path, logits)
    return len(images)
