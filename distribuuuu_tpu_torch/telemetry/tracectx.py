"""Request-scoped trace context (counterpart of
distribuuuu_tpu/telemetry/tracectx.py, byte-compatible on the wire): the
identity one request carries from the client edge to the engine, so each
stage it passes emits a ``trace.span`` record into its own rank's sink
and the rank files reassemble into one connected span tree a request.

The context is three fields: ``trace_id`` (16 hex characters minted once
at the client edge; a traced LM request's ``request_id`` too),
``parent_span`` (the span id of the sender's stage, "" at the root) and
``origin`` (the unix stamp at the trace's opening).

Carriage (``serve/protocol.py``):

* ``op="generate"`` ctrl frames embed ``"trace": {...}`` in the ctrl
  JSON (:func:`to_fields`/:func:`from_fields`); a malformed or absent
  field is the untraced path;
* binary payloads ride a NUL-lead envelope ``TRACE_MAGIC + u16 length +
  context JSON + payload`` (:func:`wrap_payload`/:func:`split_payload`);
  a torn envelope raises and the server answers ``bad_trace_envelope``;
* stream frames echo ``trace_id``.

Sampling is head-based and deterministic: :func:`should_sample` is a pure
function of the trace id (CRC32 against the rate), decided once where the
trace opens. ``SERVE.TRACE_SAMPLE 0.0`` (the default) keeps every frame
byte-identical to an untraced one, and tracing only adds ctrl keys and
records: the served tokens are the same either way.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
import zlib

from distribuuuu_tpu_torch.telemetry import spans

TRACE_SCHEMA = 1

# NUL-lead envelope magic for binary payloads; differs from the model
# envelope (b"\x00DTPUMDL1") before the length field
TRACE_MAGIC = b"\x00DTPUTRC1"

_counter = itertools.count(1)
_counter_lock = threading.Lock()


class TraceContext:
    """One request's trace identity, immutable by convention: a hop makes
    a child with :meth:`child`."""

    __slots__ = ("trace_id", "parent_span", "origin")

    def __init__(self, trace_id: str, parent_span: str = "", origin: float = 0.0):
        self.trace_id = str(trace_id)
        self.parent_span = str(parent_span)
        self.origin = float(origin)

    def child(self, parent_span: str) -> "TraceContext":
        """The context the next hop receives: the same trace, the caller's
        stage as its parent."""
        return TraceContext(self.trace_id, parent_span, self.origin)

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, parent={self.parent_span!r})"


def new_trace_id() -> str:
    """16 hex characters of OS entropy, minted once at the client edge."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """A process-unique span id (a pid-tagged counter)."""
    with _counter_lock:
        n = next(_counter)
    return f"{os.getpid():x}-{n:x}"


def should_sample(trace_id: str, rate: float) -> bool:
    """Head-based deterministic sampling: a pure function of the trace id;
    ``rate`` in [0, 1], 0 traces nothing."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return (zlib.crc32(trace_id.encode("ascii")) & 0xFFFFFFFF) < rate * 4294967296.0


def open_trace(rate: float = 1.0, origin: float | None = None):
    """The client edge's opener: a root :class:`TraceContext`, or None
    when the minted id is not sampled (the request then goes on the wire
    as an untraced one)."""
    tid = new_trace_id()
    if not should_sample(tid, rate):
        return None
    return TraceContext(tid, "", round(time.time() if origin is None else origin, 6))


def to_fields(ctx: TraceContext | None) -> dict:
    """The ``"trace"`` entry of an ``op="generate"`` ctrl frame (an empty
    dict: omit the key)."""
    if ctx is None:
        return {}
    return {"trace": {"id": ctx.trace_id, "parent": ctx.parent_span, "origin": ctx.origin}}


def from_fields(obj) -> TraceContext | None:
    """A ctrl frame's ``"trace"`` value decoded: anything but a dict with
    a non-empty string id is absent (the untraced path)."""
    if not isinstance(obj, dict):
        return None
    tid = obj.get("id")
    if not isinstance(tid, str) or not tid:
        return None
    try:
        origin = float(obj.get("origin", 0.0))
    except (TypeError, ValueError):
        origin = 0.0
    parent = obj.get("parent", "")
    return TraceContext(tid, parent if isinstance(parent, str) else "", origin)


def wrap_payload(ctx: TraceContext | None, payload: bytes) -> bytes:
    """``payload`` behind the trace envelope; None returns it untouched."""
    if ctx is None:
        return payload
    blob = json.dumps(to_fields(ctx)["trace"], separators=(",", ":")).encode("utf-8")
    if len(blob) > 0xFFFF:
        raise ValueError("trace context too large for envelope")
    return TRACE_MAGIC + struct.pack(">H", len(blob)) + blob + payload


def split_payload(payload: bytes):
    """``(context or None, inner payload)``. A payload without the magic
    is returned as it is; one with the magic but torn raises
    ``ValueError``."""
    if not payload.startswith(TRACE_MAGIC):
        return None, payload
    off = len(TRACE_MAGIC)
    if len(payload) < off + 2:
        raise ValueError("torn trace envelope (no length)")
    (n,) = struct.unpack_from(">H", payload, off)
    off += 2
    if len(payload) < off + n:
        raise ValueError("torn trace envelope (truncated context)")
    try:
        ctx = from_fields(json.loads(payload[off:off + n]))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"torn trace envelope (bad context: {e})") from e
    return ctx, payload[off + n:]


def emit_trace_span(ctx, name: str, t0: float, dur: float, parent: str | None = None,
                    span_id: str | None = None, **attrs) -> str:
    """One ``trace.span`` record in this rank's sink; returns its span id
    (a caller that handed the id to children first passes it back as
    ``span_id``). ``t0`` is this rank's ``time.perf_counter()``, mapped
    through the file's clock anchor like ``kind="span"``. Returns "" and
    writes nothing when ``ctx`` is None or telemetry is off."""
    if ctx is None or not spans.enabled():
        return ""
    sid = span_id or new_span_id()
    spans.emit_event(
        "trace.span", v=TRACE_SCHEMA, trace=ctx.trace_id, span=sid,
        parent=ctx.parent_span if parent is None else parent,
        name=name, t0=round(t0, 6), dur=round(dur, 6), **attrs,
    )
    return sid
