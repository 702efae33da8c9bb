"""Fleet router: least-loaded dispatch over a shared-nothing replica pool
(counterpart of distribuuuu_tpu/serve/fleet/router.py, the same policy,
wire bytes and records).

The router is the process clients connect to (it owns ``SERVE.HOST:PORT``
in ``python -m distribuuuu_tpu_torch.serve_net --fleet``); replicas are
full single-engine serve_net processes on ephemeral ports. Requests ride
the existing length-prefixed framing (serve/protocol.py) end to end — the
router forwards the raw payload bytes and the raw response bytes, so the
val transform and the engine dtype contract run at the replica and the
router stays thin (no torch, no PIL on the dispatch path).

Dispatch policy, per request:

1. **Least-loaded pick** — every routable replica carries a
   ``LoadSnapshot``: router-tracked in-flight depth, plus the replica's
   own queue depth / batch occupancy (from its Registry instruments,
   polled by the pool's health probes over the stats control frame), plus
   an EWMA of latencies the router itself observed. ``pick_replica`` is a
   pure function over those snapshots (tests drive it with synthetic
   ones).
2. **Idempotent retry** — serving requests are read-only, so a transport
   failure (replica died mid-request, connection refused) reroutes the
   SAME payload to the next-best replica and marks the failed one
   unroutable until a health probe clears it. ``fleet.rerouted`` counts
   these.
3. **Backpressure passthrough** — a replica's ``queue_full`` rejection is
   not the router's cue to queue: it tries the remaining replicas, and
   when EVERY routable replica rejects, the client receives the LAST
   replica's retry-after rejection payload verbatim (byte-for-byte the
   serve/admission.py shape). The router never holds a request queue of
   its own — fleet-wide overload stays client-visible, bounded, and
   honest, exactly like the single-replica engine's admission contract.

Telemetry: the router owns a Registry (fleet.* counters + the fleet-wide
latency histogram, plus one histogram per replica) and a recent-latency
window for the autoscaler's p99 reads; ``emit_telemetry`` lands
``kind="fleet.stats"`` / ``"fleet.replica"`` records in the per-rank sink
(declared in telemetry/schema.py).

Heap: the process that hosts a router serves from Python threads, so a
full garbage collection of its heap stalls every request in flight for
as long as the collection walks it. Once a fleet is routable its owner
calls :func:`freeze_heap` (a collection, then ``gc.freeze``: what the
process holds from before serving leaves the collector's walks; later
collections walk only what serving allocates) and :func:`thaw_heap` at
its shutdown.
"""

from __future__ import annotations

import gc
import json
import socket
import threading
import time
from dataclasses import dataclass, field

from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.telemetry import tracectx
from distribuuuu_tpu_torch.telemetry.registry import Registry, percentile

_ERROR_PREFIX = b'{"error"'
# replica rejections the router may retry elsewhere (read-only requests):
_BUSY_ERRORS = ("queue_full", "draining")


# -- the host process's heap while a fleet serves ---------------------------

class _Heap:
    """How many routable fleets of this process keep its heap frozen."""

    lock = threading.Lock()
    fleets = 0


def freeze_heap() -> float:
    """Collect, then freeze what this process holds (``gc.freeze``), for
    one more routable fleet; returns the collection's milliseconds: what
    a full collection of that heap costs the requests in flight."""
    with _Heap.lock:
        t0 = time.perf_counter()
        gc.collect()
        ms = (time.perf_counter() - t0) * 1e3
        gc.freeze()
        _Heap.fleets += 1
    return ms


def thaw_heap() -> None:
    """One fleet fewer; the last one hands the frozen heap back to the
    collector (``gc.unfreeze``)."""
    with _Heap.lock:
        _Heap.fleets = max(0, _Heap.fleets - 1)
        if not _Heap.fleets:
            gc.unfreeze()


# -- the least-loaded policy (pure; tests feed synthetic snapshots) ----------

@dataclass
class LoadSnapshot:
    """One replica's load as the router sees it at pick time."""

    inflight: int = 0        # router-tracked: dispatched minus answered
    queue_depth: int = 0     # replica-reported (stats probe)
    occupancy: float = 0.0   # replica-reported batch occupancy (0..1)
    ewma_ms: float = 0.0     # router-observed EWMA request latency


def load_score(snap: LoadSnapshot) -> float:
    """Expected-wait proxy: queued work ahead of a new request (router
    in-flight + replica queue) x the replica's recent per-request latency,
    weighted up when its batches are running full (a saturated replica
    drains slower than its EWMA suggests). Lower is better."""
    depth = max(0, snap.inflight) + max(0, snap.queue_depth)
    busy = 1.0 + max(0.0, min(1.0, snap.occupancy))
    return (1.0 + depth) * busy * max(snap.ewma_ms, 0.1)


def pick_replica(snaps: list[LoadSnapshot | None], rr: int = 0) -> int | None:
    """Index of the least-loaded replica (None entries are unroutable).
    Ties break round-robin via ``rr`` so equally-idle replicas share cold
    traffic instead of replica 0 taking it all."""
    best, best_score = None, None
    n = len(snaps)
    for k in range(n):
        i = (rr + k) % n
        if snaps[i] is None:
            continue
        s = load_score(snaps[i])
        if best_score is None or s < best_score:
            best, best_score = i, s
    return best


# -- one replica, as the router tracks it ------------------------------------

@dataclass
class Replica:
    id: int
    host: str
    port: int
    proc: object = None            # pool-owned process handle (or None)
    model: str = ""                # model id this replica serves ("": sole model)
    routable: bool = False
    warmed: bool = False           # warm-up completed at least once
    warm_jit_compiles: int = 0     # jit.compiles (graph captures) at warm-up
    draining: bool = False
    inflight: int = 0
    ewma_ms: float = 0.0
    requests: int = 0
    stats: dict = field(default_factory=dict)  # last health-probe snapshot
    fails: int = 0
    _conns: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def snapshot(self) -> LoadSnapshot | None:
        if not self.routable or self.draining:
            return None
        return LoadSnapshot(
            inflight=self.inflight,
            queue_depth=int(self.stats.get("queue_depth", 0)),
            occupancy=float(self.stats.get("batch_occupancy", 0.0)),
            ewma_ms=self.ewma_ms,
        )

    def _get_conn(self, timeout: float) -> socket.socket:
        with self._lock:
            if self._conns:
                return self._conns.pop()
        conn = socket.create_connection(self.addr, timeout=timeout)
        conn.settimeout(timeout)
        return conn

    def _put_conn(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.append(conn)

    def close_conns(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def roundtrip(self, payload: bytes, timeout: float) -> bytes:
        """One request/response over a pooled connection. Raises OSError
        on any transport failure (the caller reroutes)."""
        conn = self._get_conn(timeout)
        try:
            protocol.send_frame(conn, payload)
            resp = protocol.recv_frame(conn)
        except (OSError, ValueError):
            conn.close()
            raise
        if resp is None:  # replica closed mid-request
            conn.close()
            raise ConnectionResetError(f"replica {self.id} closed connection")
        self._put_conn(conn)
        return resp


class _LastFrame:
    """A stand-in client socket for ``Router.dispatch_generate``: keeps the
    payload of the last frame ``protocol.send_frame`` wrote to it."""

    frame = None

    def sendall(self, data: bytes) -> None:
        self.frame = data[4:]  # one send_frame: the length prefix, then the payload


class NoRoutableReplicaError(RuntimeError):
    """Every replica is dead, draining, or not yet warm."""


class Router:
    """Request dispatcher + fleet-wide observability. The pool
    (fleet/pool.py) owns replica lifecycle and calls
    ``add_replica``/``mark_routable``/``mark_draining``/``remove_replica``;
    the router only routes."""

    EWMA_ALPHA = 0.2

    def __init__(self, *, request_timeout_s: float = 60.0,
                 recent_window: int = 4096,
                 long_prompt_threshold: int = 0,
                 short_p99_slo_ms: float | None = None,
                 long_p99_slo_ms: float | None = None):
        self._replicas: dict[int, Replica] = {}
        self._lock = threading.Lock()
        self._rr = 0
        self._next_id = 0
        self.request_timeout_s = float(request_timeout_s)
        self.registry = Registry()
        self._lat = self.registry.histogram("fleet.latency_s")
        # (t_done, latency_s, trace_id|None) ring: the autoscaler's
        # windowed p99 source AND the exemplar store — traced samples
        # keep their trace id so a p99 breach can name its worst
        # offenders (window_stats "exemplars")
        self._recent: list[tuple[float, float, str | None]] = []
        self._recent_cap = recent_window
        self._t0 = time.perf_counter()
        # multi-model multiplexing: model id -> SLO class
        # record, and per-model routing stats. Empty for single-model
        # fleets — bare (non-enveloped) payloads never consult either.
        self._models: dict[str, dict] = {}
        self._mstats: dict[str, dict] = {}
        # length-aware routing stats (the long-context plane): generate
        # ctrl frames with >= long_prompt_threshold prompt tokens are the
        # "long" class; per-class windowed latencies surface next to the
        # per-model SLO rows (window_stats "length:short"/"length:long")
        # so the slo-breach rule referees short-class p99 against long-
        # prompt interference unchanged. 0 disables classification.
        self.long_prompt_threshold = int(long_prompt_threshold)
        self._lslo = {
            "short": float(short_p99_slo_ms) if short_p99_slo_ms else None,
            "long": float(long_p99_slo_ms) if long_p99_slo_ms else None,
        }
        self._lstats: dict[str, dict] = {}

    # -- model registry (multi-model fleets) -------------------------------
    @staticmethod
    def _fresh_mstat() -> dict:
        return {"requests": 0, "rejected": 0, "degraded_out": 0,
                "degraded_in": 0, "recent": []}

    def register_model(self, name: str, *, slo_class: str = "standard",
                       p99_slo_ms: float | None = None,
                       overflow_to: str | None = None) -> None:
        """Declare a model id and its SLO class. ``overflow_to`` names the
        cheaper model that absorbs this model's traffic when every one of
        its replicas is saturated — the degrade-under-pressure path
        (counted, never silent)."""
        with self._lock:
            self._models[name] = {
                "slo_class": str(slo_class),
                "p99_slo_ms": None if p99_slo_ms is None else float(p99_slo_ms),
                "overflow_to": overflow_to,
            }
            self._mstats.setdefault(name, self._fresh_mstat())

    def registered_models(self) -> list[str]:
        """Every routable model id: registered ones plus any a replica was
        tagged with (the wrong-model-id error lists these)."""
        with self._lock:
            names = set(self._models)
            names.update(
                r.model for r in self._replicas.values() if r.model
            )
            return sorted(names)

    # -- replica membership (pool-driven) ---------------------------------
    def add_replica(self, host: str, port: int, *, proc=None,
                    replica_id: int | None = None,
                    model: str = "") -> Replica:
        """Register a replica in the NOT-routable (warming) state — the
        pool flips it routable only after the warm-up probe confirms every
        bucket shape is warmed (its graph captured). ``model`` tags the replica for model-id
        routing (multi-model fleets); untagged replicas serve bare
        payloads exactly as before."""
        with self._lock:
            rid = self._next_id if replica_id is None else int(replica_id)
            self._next_id = max(self._next_id, rid + 1)
            rep = Replica(
                id=rid, host=host, port=int(port), proc=proc, model=model
            )
            self._replicas[rid] = rep
            if model:
                self._mstats.setdefault(model, self._fresh_mstat())
            return rep

    def mark_routable(self, rid: int) -> None:
        with self._lock:
            self._replicas[rid].routable = True

    def mark_draining(self, rid: int) -> None:
        """Stop routing NEW requests to a replica; in-flight ones finish
        (the drain-before-exit half of a draining restart)."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is not None:
                rep.draining = True

    def remove_replica(self, rid: int) -> Replica | None:
        with self._lock:
            rep = self._replicas.pop(rid, None)
        if rep is not None:
            rep.close_conns()
        return rep

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def get_replica(self, rid: int) -> Replica | None:
        with self._lock:
            return self._replicas.get(rid)

    def n_routable(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values()
                if r.routable and not r.draining
            )

    # -- length classes (long-context serving) -----------------------------
    @staticmethod
    def _fresh_lstat() -> dict:
        return {"requests": 0, "rejected": 0, "recent": []}

    def _classify_payload(self, payload: bytes) -> str | None:
        """"short" / "long" for a generate ctrl frame when length
        classification is on (by prompt token count — "text" prompts
        count utf-8 bytes, the byte tokenizer's 1:1 identity); None for
        everything else. The router classifies from the frame alone, so
        per-class accounting needs no replica cooperation."""
        if not self.long_prompt_threshold:
            return None
        if not payload.startswith(protocol.CTRL_MAGIC[:1]):
            return None
        try:
            ctrl = protocol.parse_ctrl(payload)
        except (ValueError, UnicodeDecodeError):
            return None
        if not ctrl or ctrl.get("op") != "generate":
            return None
        if "tokens" in ctrl:
            n = len(ctrl["tokens"])
        else:
            n = len(str(ctrl.get("text", "")).encode("utf-8"))
        return "long" if n >= self.long_prompt_threshold else "short"

    # -- dispatch ----------------------------------------------------------
    def _pick(self, exclude: set[int],
              model: str | None = None) -> Replica | None:
        """Least-loaded routable replica outside ``exclude``; with
        ``model``, only replicas tagged with that model id count."""
        with self._lock:
            reps = list(self._replicas.values())
            snaps = [
                (r.snapshot()
                 if r.id not in exclude
                 and (model is None or r.model == model) else None)
                for r in reps
            ]
            self._rr += 1
            idx = pick_replica(snaps, rr=self._rr)
            return None if idx is None else reps[idx]

    def _note_failure(self, rep: Replica) -> None:
        """Transport failure: stop routing to it now; the pool's health
        probe decides dead-vs-transient and restores or replaces it."""
        with self._lock:
            rep.routable = False
        rep.close_conns()
        self.registry.counter("fleet.replica_failures").inc(1)

    def _observe(self, rep: Replica, lat_s: float,
                 model: str | None = None,
                 length_class: str | None = None,
                 trace: str | None = None) -> None:
        now = time.perf_counter()
        with self._lock:
            rep.requests += 1
            rep.ewma_ms = (
                lat_s * 1e3 if rep.ewma_ms == 0.0
                else (1 - self.EWMA_ALPHA) * rep.ewma_ms
                + self.EWMA_ALPHA * lat_s * 1e3
            )
            self._recent.append((now, lat_s, trace))
            if len(self._recent) > self._recent_cap:
                del self._recent[: self._recent_cap // 4]
            if model:
                ms = self._mstats.setdefault(model, self._fresh_mstat())
                ms["requests"] += 1
                ms["recent"].append((now, lat_s, trace))
                if len(ms["recent"]) > self._recent_cap:
                    del ms["recent"][: self._recent_cap // 4]
            if length_class:
                ls = self._lstats.setdefault(
                    length_class, self._fresh_lstat()
                )
                ls["requests"] += 1
                ls["recent"].append((now, lat_s, trace))
                if len(ls["recent"]) > self._recent_cap:
                    del ls["recent"][: self._recent_cap // 4]
        self._lat.observe(lat_s)
        self.registry.histogram(f"fleet.replica{rep.id}.latency_s").observe(
            lat_s
        )
        self.registry.counter("fleet.requests").inc(1)

    def _try_dispatch(
        self, payload: bytes, model: str | None, t0: float,
        trace: tracectx.TraceContext | None = None, parent: str = "",
    ) -> tuple[bytes | None, bytes | None]:
        """The retry loop over one model's (or, with None, every)
        replica set: ``(response, last_busy)``. ``response`` is None when
        every candidate was busy, failed, or unroutable — the caller
        decides between overflow, verbatim rejection, and the router
        error. A traced request (``trace``) is re-enveloped per attempt
        with ``parent`` (the router's dispatch span) so the replica's
        spans attach under it, and every failed attempt lands a
        ``router.reroute`` span in the tree."""
        tried: set[int] = set()
        last_busy: bytes | None = None
        wire = payload if trace is None else tracectx.wrap_payload(
            trace.child(parent), payload
        )
        while True:
            rep = self._pick(tried, model=model)
            if rep is None:
                return None, last_busy
            with self._lock:
                rep.inflight += 1
            t_at = time.perf_counter()
            try:
                resp = rep.roundtrip(wire, self.request_timeout_s)
            except (OSError, ValueError):
                self._note_failure(rep)
                self.registry.counter("fleet.rerouted").inc(1)
                tried.add(rep.id)
                tracectx.emit_trace_span(
                    trace, "router.reroute", t_at,
                    time.perf_counter() - t_at, parent=parent,
                    replica=rep.id,
                )
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
            if resp.startswith(_ERROR_PREFIX):
                try:
                    err = json.loads(resp).get("error")
                except (ValueError, AttributeError):
                    err = None
                if err in _BUSY_ERRORS:
                    # this replica is saturated/draining — try the rest,
                    # and keep its rejection for verbatim passthrough
                    last_busy = resp
                    tried.add(rep.id)
                    continue
            self._observe(
                rep, time.perf_counter() - t0, model=model,
                trace=None if trace is None else trace.trace_id,
            )
            return resp, last_busy

    def _count_rejected(self, model: str | None,
                        length_class: str | None = None) -> None:
        self.registry.counter("fleet.rejected").inc(1)
        with self._lock:
            if model:
                self._mstats.setdefault(
                    model, self._fresh_mstat()
                )["rejected"] += 1
            if length_class:
                self._lstats.setdefault(
                    length_class, self._fresh_lstat()
                )["rejected"] += 1

    def dispatch(self, payload: bytes) -> bytes:
        """Route one request payload; returns the response payload.

        Model-enveloped payloads (protocol.model_envelope) route only to
        replicas tagged with that model id — an unknown id is refused
        with the registered-model list; when EVERY replica of a model
        with a configured ``overflow_to`` is saturated, the stripped
        payload spills to the cheap model instead of being rejected
        (counted as degraded, per model). Bare payloads keep the
        single-model semantics exactly.

        Transport failures reroute (idempotent requests); fleet-wide
        saturation returns the last replica's retry-after rejection
        VERBATIM; a fleet with nothing routable returns a router-level
        error record in the same JSON shape.

        Traced payloads (tracectx.TRACE_MAGIC, outermost) are stripped
        here; the routed attempt re-envelopes with the router's dispatch
        span as the new parent, and one ``router.dispatch`` span (plus a
        ``router.reroute`` per failed attempt) lands in this rank's
        sink. Untraced payloads take the exact pre-tracing path."""
        t0 = time.perf_counter()
        try:
            trace, payload = tracectx.split_payload(payload)
        except ValueError:
            return json.dumps({"error": "bad_trace_envelope"}).encode()
        dsid = "" if trace is None else tracectx.new_span_id()
        resp = self._dispatch_routed(payload, t0, trace, dsid)
        if trace is not None:
            err = None
            if resp.startswith(_ERROR_PREFIX):
                try:
                    err = json.loads(resp).get("error")
                except (ValueError, AttributeError):
                    err = "unparseable_error"
            tracectx.emit_trace_span(
                trace, "router.dispatch", t0, time.perf_counter() - t0,
                span_id=dsid, ok=(err is None),
                **({} if err is None else {"error": err}),
            )
        return resp

    def _dispatch_routed(self, payload: bytes, t0: float,
                         trace: tracectx.TraceContext | None,
                         dsid: str) -> bytes:
        model, inner = protocol.split_model_envelope(payload)
        if model is not None:
            known = self.registered_models()
            if model not in known:
                self.registry.counter("fleet.unknown_model").inc(1)
                return json.dumps({
                    "error": "unknown_model",
                    "model": model,
                    "models": known,
                }).encode()
        resp, last_busy = self._try_dispatch(
            inner, model, t0, trace=trace, parent=dsid
        )
        if resp is not None:
            return resp
        if model is not None:
            with self._lock:
                mrec = self._models.get(model)
                spill = mrec.get("overflow_to") if mrec else None
            if spill:
                resp, spill_busy = self._try_dispatch(
                    inner, spill, t0, trace=trace, parent=dsid
                )
                if resp is not None:
                    # the cheap model absorbed the overflow: a degraded
                    # answer beats a rejected one, and both sides count it
                    self.registry.counter("fleet.degraded").inc(1)
                    with self._lock:
                        self._mstats.setdefault(
                            model, self._fresh_mstat()
                        )["degraded_out"] += 1
                        self._mstats.setdefault(
                            spill, self._fresh_mstat()
                        )["degraded_in"] += 1
                    return resp
                last_busy = spill_busy or last_busy
        if last_busy is not None:
            self._count_rejected(model)
            return last_busy
        self.registry.counter("fleet.unroutable").inc(1)
        if model is not None:
            with self._lock:
                self._mstats.setdefault(
                    model, self._fresh_mstat()
                )["rejected"] += 1
        return json.dumps(
            {"error": "no_routable_replicas", "retry_after_ms": 1000.0}
        ).encode()

    def dispatch_stream(self, payload: bytes, client: socket.socket,
                        model: str | None = None) -> None:
        """Route one STREAMING request (the LM ``op="generate"`` ctrl
        frame, lm/service.py): pick a replica exactly like ``dispatch``,
        then relay its whole frame sequence — token frames as they decode,
        the done frame last — straight to the client. Tokens stream
        through the router; nothing buffers. A generate ctrl frame may
        carry ``"model"``: the stream then routes only to that model's
        replicas (unknown ids are refused with the registered list; no
        overflow — a stream is not idempotently spillable once committed
        to a model's weights).

        Retry semantics are necessarily narrower than ``dispatch``'s: a
        transport failure BEFORE the first frame reroutes (nothing
        reached the client — still idempotent); after a partial stream
        the client gets a done frame carrying the error (re-running the
        prefix would emit duplicate tokens). Busy rejections pass through
        verbatim when every replica rejects, the admission contract.

        A traced generate frame (``"trace"`` in the ctrl JSON) has its
        context re-pointed at the router's dispatch span before
        forwarding, so the replica engine's spans attach under this hop;
        the router lands ``router.pick`` per attempt, ``router.reroute``
        per transport failure, and one ``router.dispatch`` covering the
        whole relay. Untraced frames forward byte-identically."""
        t0 = time.perf_counter()
        trace = None
        if payload.startswith(protocol.CTRL_MAGIC):
            try:
                ctrl = protocol.parse_ctrl(payload)
                trace = tracectx.from_fields((ctrl or {}).get("trace"))
            except (ValueError, UnicodeDecodeError):
                trace = None
        dsid = "" if trace is None else tracectx.new_span_id()
        if trace is not None:
            # downstream spans parent onto the router's dispatch span —
            # only TRACED frames are re-encoded; untraced bytes forward
            # exactly as received
            ctrl["trace"] = {"id": trace.trace_id, "parent": dsid,
                             "origin": trace.origin}
            payload = protocol.CTRL_MAGIC + json.dumps(ctrl).encode()
        if model is not None and model not in self.registered_models():
            self.registry.counter("fleet.unknown_model").inc(1)
            protocol.send_frame(client, json.dumps({
                "error": "unknown_model",
                "model": model,
                "models": self.registered_models(),
            }).encode())
            return
        length_class = self._classify_payload(payload)
        tried: set[int] = set()
        last_busy: bytes | None = None
        while True:
            t_pick = time.perf_counter()
            rep = self._pick(tried, model=model)
            if rep is None:
                break
            tracectx.emit_trace_span(
                trace, "router.pick", t_pick,
                time.perf_counter() - t_pick, parent=dsid,
                replica=rep.id,
            )
            with self._lock:
                rep.inflight += 1
            conn = None
            streamed = 0
            try:
                # a pooled connection, as ``Replica.roundtrip``'s: the
                # replica serves one stream after another on it, so a
                # stream costs it no accept and no handler thread (under a
                # burst of refused streams those were its bottleneck)
                conn = rep._get_conn(self.request_timeout_s)
                protocol.send_frame(conn, payload)
                busy = False
                while True:
                    frame = protocol.recv_frame(conn)
                    if frame is None:
                        raise ConnectionResetError(
                            f"replica {rep.id} closed mid-stream"
                        )
                    if streamed == 0 and frame.startswith(_ERROR_PREFIX):
                        try:
                            err = json.loads(frame).get("error")
                        except (ValueError, AttributeError):
                            err = None
                        if err in _BUSY_ERRORS:
                            last_busy = frame
                            tried.add(rep.id)
                            busy = True
                            break  # try the next replica
                    done = (
                        b'"stream": "done"' in frame[:64]
                        or frame.startswith(_ERROR_PREFIX)
                    )
                    if done:
                        # account the stream BEFORE forwarding its final
                        # frame: the client unblocks the moment it reads
                        # "done", and an after-the-send increment races
                        # anything that checks the counters then
                        self._observe(
                            rep, time.perf_counter() - t0, model=model,
                            length_class=length_class,
                            trace=None if trace is None
                            else trace.trace_id,
                        )
                        self.registry.counter("fleet.streams").inc(1)
                        tracectx.emit_trace_span(
                            trace, "router.dispatch", t0,
                            time.perf_counter() - t0, span_id=dsid,
                            replica=rep.id, frames=streamed + 1,
                            ok=not frame.startswith(_ERROR_PREFIX),
                        )
                    protocol.send_frame(client, frame)
                    streamed += 1
                    if done:
                        rep._put_conn(conn)
                        conn = None
                        return
                if busy:
                    rep._put_conn(conn)
                    conn = None
                    continue  # busy rejection: next replica
            except (OSError, ValueError) as e:
                self._note_failure(rep)
                self.registry.counter("fleet.rerouted").inc(1)
                tried.add(rep.id)
                tracectx.emit_trace_span(
                    trace, "router.reroute", t_pick,
                    time.perf_counter() - t_pick, parent=dsid,
                    replica=rep.id, streamed=streamed,
                )
                if streamed:
                    # tokens already reached the client — re-running the
                    # request would duplicate them; fail THIS stream
                    tracectx.emit_trace_span(
                        trace, "router.dispatch", t0,
                        time.perf_counter() - t0, span_id=dsid,
                        replica=rep.id, frames=streamed, ok=False,
                        error="replica_failed_mid_stream",
                    )
                    try:
                        protocol.send_frame(client, json.dumps({
                            "stream": "done",
                            "error": f"replica failed mid-stream: "
                                     f"{type(e).__name__}: {e}",
                            "n": streamed - 1,
                        }).encode())
                    except OSError:
                        pass
                    return
                continue
            finally:
                with self._lock:
                    rep.inflight -= 1
                if conn is not None:
                    conn.close()
        if last_busy is not None:
            self._count_rejected(model, length_class=length_class)
            tracectx.emit_trace_span(
                trace, "router.dispatch", t0, time.perf_counter() - t0,
                span_id=dsid, ok=False, error="busy",
            )
            protocol.send_frame(client, last_busy)
            return
        self.registry.counter("fleet.unroutable").inc(1)
        tracectx.emit_trace_span(
            trace, "router.dispatch", t0, time.perf_counter() - t0,
            span_id=dsid, ok=False, error="no_routable_replicas",
        )
        protocol.send_frame(client, json.dumps(
            {"error": "no_routable_replicas", "retry_after_ms": 1000.0}
        ).encode())

    def dispatch_generate(self, payload: bytes,
                          model: str | None = None) -> bytes:
        """In-process façade over ``dispatch_stream`` for callers that
        want one classified outcome per generate request rather than a
        client socket to relay into (the campaign runner's LM path): the
        stream's frames go to an in-memory sink that keeps the last, and
        the FINAL frame (done / busy / error) is returned."""
        sink = _LastFrame()
        self.dispatch_stream(payload, sink, model=model)
        if sink.frame is None:
            return json.dumps(
                {"error": "no_routable_replicas", "retry_after_ms": 1000.0}
            ).encode()
        return sink.frame

    # -- observability -----------------------------------------------------
    def window_stats(self, window_s: float) -> dict:
        """Latency percentiles over the trailing ``window_s`` plus total
        queued work — the autoscaler's observation."""
        cut = time.perf_counter() - window_s
        with self._lock:
            lats = sorted(
                lat for (t, lat, _tr) in self._recent if t >= cut
            )
            # exemplar attribution: the worst <= 3 TRACED
            # samples in the window, so a p99 breach names concrete
            # trace ids instead of a bare percentile
            exemplars = sorted(
                ((lat, tr) for (t, lat, tr) in self._recent
                 if t >= cut and tr),
                reverse=True,
            )[:3]
            queue_depth = sum(
                r.inflight + int(r.stats.get("queue_depth", 0))
                for r in self._replicas.values()
                if r.routable and not r.draining
            )
            models = {}
            for name, ms in self._mstats.items():
                mlats = sorted(
                    lat for (t, lat, _tr) in ms["recent"] if t >= cut
                )
                mrec = self._models.get(name) or {}
                models[name] = {
                    "samples": len(mlats),
                    "p99_ms": round(percentile(mlats, 0.99) * 1e3, 3),
                    "target_ms": mrec.get("p99_slo_ms"),
                }
            # length classes ride the same models dict as "length:short"
            # / "length:long" rows (same {samples, p99_ms, target_ms}
            # shape), so the slo-breach rule — which scans serve.models
            # for targeted rows — referees per-class p99 unchanged
            for name, ls in self._lstats.items():
                llats = sorted(
                    lat for (t, lat, _tr) in ls["recent"] if t >= cut
                )
                models[f"length:{name}"] = {
                    "samples": len(llats),
                    "p99_ms": round(percentile(llats, 0.99) * 1e3, 3),
                    "target_ms": self._lslo.get(name),
                }
        out = {
            "samples": len(lats),
            "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
            "p90_ms": round(percentile(lats, 0.90) * 1e3, 3),
            "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
            "queue_depth": queue_depth,
        }
        if exemplars:
            out["exemplars"] = [
                {"trace": tr, "latency_ms": round(lat * 1e3, 3)}
                for (lat, tr) in exemplars
            ]
        if models:
            # per-model windowed p99 against its SLO target — what the
            # slo-breach rule reads (telemetry/live.py)
            out["models"] = models
        return out

    def _counter(self, name: str) -> int:
        return int(self.registry.counter(name).value)

    def stats(self) -> dict:
        """Fleet-wide + per-replica snapshot (the router's own stats
        control-frame response)."""
        lat = self._lat.values()
        with self._lock:
            reps = list(self._replicas.values())
        per_replica = [
            {
                "replica": r.id,
                "port": r.port,
                "routable": bool(r.routable and not r.draining),
                "draining": r.draining,
                "inflight": r.inflight,
                "queue_depth": int(r.stats.get("queue_depth", 0)),
                "occupancy": float(r.stats.get("batch_occupancy", 0.0)),
                "ewma_ms": round(r.ewma_ms, 3),
                "requests": r.requests,
                "jit_compiles": int(r.stats.get("jit_compiles", 0)),
                "warm_jit_compiles": r.warm_jit_compiles,
                "aot_compiles": int(r.stats.get("aot_compiles", 0)),
                "model": r.model,
            }
            for r in reps
        ]
        with self._lock:
            names = set(self._models)
            names.update(r.model for r in reps if r.model)
            models = {}
            for name in sorted(names):
                mrec = self._models.get(name) or {}
                ms = self._mstats.get(name) or self._fresh_mstat()
                mlats = [lat for (_t, lat, _tr) in ms["recent"]]
                models[name] = {
                    "slo_class": mrec.get("slo_class", "standard"),
                    "p99_slo_ms": mrec.get("p99_slo_ms"),
                    "overflow_to": mrec.get("overflow_to"),
                    "replicas": sum(1 for r in reps if r.model == name),
                    "requests": ms["requests"],
                    "rejected": ms["rejected"],
                    "degraded_out": ms["degraded_out"],
                    "degraded_in": ms["degraded_in"],
                    "p99_ms": round(percentile(mlats, 0.99) * 1e3, 3),
                }
        with self._lock:
            length_classes = {
                name: {
                    "p99_slo_ms": self._lslo.get(name),
                    "requests": ls["requests"],
                    "rejected": ls["rejected"],
                    "p99_ms": round(
                        percentile(
                            [lat for (_t, lat, _tr) in ls["recent"]], 0.99
                        ) * 1e3, 3,
                    ),
                }
                for name, ls in sorted(self._lstats.items())
            }
        window = max(time.perf_counter() - self._t0, 1e-9)
        out = {
            "replicas": len(reps),
            "routable": sum(1 for p in per_replica if p["routable"]),
            "requests": self._counter("fleet.requests"),
            "rejected": self._counter("fleet.rejected"),
            "rerouted": self._counter("fleet.rerouted"),
            "unroutable": self._counter("fleet.unroutable"),
            "degraded": self._counter("fleet.degraded"),
            "unknown_model": self._counter("fleet.unknown_model"),
            "replica_failures": self._counter("fleet.replica_failures"),
            "throughput_rps": round(
                self._counter("fleet.requests") / window, 2
            ),
            "p50_ms": round(percentile(lat, 0.50) * 1e3, 3),
            "p90_ms": round(percentile(lat, 0.90) * 1e3, 3),
            "p99_ms": round(percentile(lat, 0.99) * 1e3, 3),
            "per_replica": per_replica,
        }
        if models:
            out["models"] = models
        if length_classes:
            out["length_classes"] = length_classes
            out["long_prompt_threshold"] = self.long_prompt_threshold
        return out

    def emit_telemetry(self) -> None:
        """One ``fleet.stats`` + one ``fleet.replica`` per replica (plus
        one ``fleet.model_route`` per registered model on multi-model
        fleets, and one ``fleet.length_class`` per observed length class
        on length-aware fleets) into the per-rank telemetry sink (no-op
        until setup_telemetry ran)."""
        from distribuuuu_tpu_torch.telemetry import spans

        snap = self.stats()
        per_replica = snap.pop("per_replica")
        models = snap.pop("models", {})
        length_classes = snap.pop("length_classes", {})
        snap.pop("long_prompt_threshold", None)
        spans.emit_event("fleet.stats", **snap)
        for p in per_replica:
            spans.emit_event("fleet.replica", **p)
        for name, m in models.items():
            spans.emit_event(
                "fleet.model_route",
                model=name,
                requests=m["requests"],
                rejected=m["rejected"],
                degraded_in=m["degraded_in"],
                degraded_out=m["degraded_out"],
                p99_ms=m["p99_ms"],
            )
        for name, lc in length_classes.items():
            spans.emit_event(
                "fleet.length_class",
                length_class=name,
                threshold=self.long_prompt_threshold,
                requests=lc["requests"],
                rejected=lc["rejected"],
                p99_ms=lc["p99_ms"],
            )

    # -- the client-facing accept loop ------------------------------------
    def _handle_conn(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    payload = protocol.recv_frame(conn)
                except (OSError, ValueError):
                    return
                if payload is None:
                    return
                ctrl = (
                    protocol.parse_ctrl(payload)
                    if payload.startswith(protocol.CTRL_MAGIC[:1]) else None
                )
                if ctrl is not None:
                    if ctrl.get("op") == "generate":
                        # streaming passthrough: the replica's whole frame
                        # sequence relays on this client connection
                        try:
                            self.dispatch_stream(
                                payload, conn, model=ctrl.get("model")
                            )
                        except OSError:
                            return
                        continue
                    if ctrl.get("op") == "stats":
                        snap = self.stats()
                        # a stats request carrying window_s also gets the
                        # trailing-window latency view (the autoscaler's
                        # observation) — the live monitor's p99 source
                        if ctrl.get("window_s"):
                            snap["window"] = self.window_stats(
                                float(ctrl["window_s"])
                            )
                        resp = json.dumps(snap).encode()
                    else:
                        resp = json.dumps(
                            {"error": f"unknown control op {ctrl.get('op')!r}"}
                        ).encode()
                else:
                    resp = self.dispatch(payload)
                try:
                    protocol.send_frame(conn, resp)
                except OSError:
                    return

    def serve(self, listener: socket.socket, should_stop,
              poll_s: float = 0.25, emit_interval_s: float = 0.0) -> None:
        """Accept loop: one handler thread per client connection (each
        multiplexes that client's requests over the fleet). Polls
        ``should_stop()`` between accepts — the SIGTERM drain flag in
        ``serve_net --fleet``."""
        listener.settimeout(poll_s)
        handlers: list[threading.Thread] = []
        last_emit = time.perf_counter()
        try:
            while not should_stop():
                if (
                    emit_interval_s
                    and time.perf_counter() - last_emit >= emit_interval_s
                ):
                    self.emit_telemetry()
                    last_emit = time.perf_counter()
                try:
                    conn, _addr = listener.accept()
                except socket.timeout:
                    continue
                t = threading.Thread(
                    target=self._handle_conn, args=(conn,), daemon=True
                )
                t.start()
                handlers.append(t)
        finally:
            listener.close()
            for t in handlers:
                t.join(timeout=5.0)
