"""Campaign runner: replay a seeded schedule against a real fleet and let
the alert-rule engine referee every phase (counterpart of
distribuuuu_tpu/serve/campaign/runner.py).

The runner OPEN-LOOP replays the schedule ``build_schedule`` produced
(arrival times are absolute, not feedback-coupled: a saturated fleet
faces the same offered load a healthy one does, which is what makes
backpressure observable), samples router-derived snapshots every
``interval_s``, and feeds them to a FRESH ``RuleEngine`` per phase armed
with the campaign's rules. A phase passes iff the raised alert-kind set
equals its ``expect`` list EXACTLY: control phases must stay silent, so
a rule that false-positives fails the campaign as loudly as one that
misses.

The snapshots are serve-shaped (``totals.steps`` counts served
requests; the training-plane fields are zeroed), so campaigns may arm
only the serve-evaluable kinds in ``dsl.CAMPAIGN_RULE_KINDS``.

``rolling_update`` phases trigger ``MultiModelFleet.rolling_update``
mid-phase (at ``at_frac`` of the phase) while the schedule keeps
arriving; the phase record pins ``logits_changed`` (a fixed probe's
logits differ across the swap) and ``failed_during`` (the drain ordering
promises zero).

Each phase record also carries ``send_lag_ms``: p50/p99 of each
request's actual send time minus its scheduled time. A phase whose
client fell behind its schedule did not offer the load it names, so its
verdict says nothing about the fleet. ``latencies[i]`` holds phase i's
image requests as ``(scheduled s, client-side seconds)``, for a caller
that reads the tail the router's windows referee.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.serve.campaign import dsl
from distribuuuu_tpu_torch.telemetry import tracectx
from distribuuuu_tpu_torch.telemetry.live import SNAPSHOT_SCHEMA, AlertRule, RuleEngine
from distribuuuu_tpu_torch.telemetry.registry import percentile
from distribuuuu_tpu_torch.utils.logger import get_logger

_BACKOFF = ("queue_full", "draining", "no_routable_replicas")


class CampaignRunner:
    """Replays one ``CampaignSpec`` against a router (in-process; the
    router→replica hops are the real framed sockets).

    ``payload_for(model)`` returns one raw request payload for that model
    (the runner wraps it in the model envelope itself). ``fleet`` (a
    MultiModelFleet) is only needed for rolling_update phases.
    """

    def __init__(self, spec: dsl.CampaignSpec, router, *, payload_for,
                 fleet=None, max_workers: int = 32,
                 trace_sample: float = 0.0):
        self.spec = spec
        self.router = router
        self.fleet = fleet
        self._payload_for = payload_for
        # fraction of generate requests that open a trace at the campaign
        # edge (head-based deterministic sampling); 0.0 keeps every frame
        # byte-identical to an untraced campaign
        self._trace_sample = float(trace_sample)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="campaign"
        )
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._bounds = [
            dsl.phase_window(spec, i) for i in range(len(spec.phases))
        ]
        self._starts = [b[0] for b in self._bounds]
        self._counts = [
            {"sent": 0, "ok": 0, "busy": 0, "failed": 0, "unknown_model": 0}
            for _ in spec.phases
        ]
        self._lags: list[list[float]] = [[] for _ in spec.phases]
        self.latencies: list[list[tuple]] = [[] for _ in spec.phases]
        self._t0 = 0.0
        self.logger = get_logger()

    # -- load generation ---------------------------------------------------
    def _phase_index(self, t: float) -> int:
        return max(0, bisect.bisect_right(self._starts, t) - 1)

    def _job(self, t: float, model: str, size: int) -> None:
        pi = self._phase_index(t)
        lag = time.perf_counter() - (self._t0 + t)
        with self._lock:
            self._lags[pi].append(lag)
        payload = self._payload_for(model)
        # LM campaigns: payload_for returns an ``op="generate"`` ctrl
        # frame; the model rides IN the ctrl frame (dispatch_stream's
        # contract), not the envelope, and the final streamed frame is
        # what classifies the request
        generate = payload.startswith(protocol.CTRL_MAGIC)
        frame = payload if generate else protocol.model_envelope(
            model, payload
        )
        for _ in range(size):
            if self._stop.is_set():
                return
            cls = "failed"
            try:
                if generate:
                    req, ctx, esid = frame, None, ""
                    if self._trace_sample > 0.0:
                        # open a per-request trace at the campaign edge:
                        # the edge span is the tree's root; the router
                        # re-points the parent at its own dispatch span
                        ctx = tracectx.open_trace(self._trace_sample)
                        if ctx is not None:
                            esid = tracectx.new_span_id()
                            ctrl = protocol.parse_ctrl(frame) or {}
                            ctrl.update(
                                tracectx.to_fields(ctx.child(esid))
                            )
                            req = protocol.CTRL_MAGIC + json.dumps(
                                ctrl
                            ).encode("utf-8")
                    # final frame of the stream: a clean done frame has
                    # no "error" key; a mid-stream failure rides the done
                    # frame itself, so classify on the parsed record
                    t_req = time.perf_counter()
                    rec = json.loads(self.router.dispatch_generate(
                        req, model=model
                    ))
                    err = rec.get("error")
                    if err is None and rec.get("stream") == "done":
                        cls = "ok"
                    elif err in _BACKOFF:
                        cls = "busy"
                    elif err == "unknown_model":
                        cls = "unknown_model"
                    tracectx.emit_trace_span(
                        ctx, "client.request", t_req,
                        time.perf_counter() - t_req, parent="",
                        span_id=esid, ok=(err is None),
                    )
                    with self._lock:
                        self._counts[pi]["sent"] += 1
                        self._counts[pi][cls] += 1
                    continue
                t_req = time.perf_counter()
                resp = self.router.dispatch(frame)
                with self._lock:
                    self.latencies[pi].append((t, time.perf_counter() - t_req))
                if not resp.startswith(b'{"error"'):
                    cls = "ok"
                else:
                    err = json.loads(resp).get("error")
                    if err in _BACKOFF:
                        cls = "busy"
                    elif err == "unknown_model":
                        cls = "unknown_model"
            except Exception:  # noqa: BLE001 — load-gen must not die
                cls = "failed"
            with self._lock:
                self._counts[pi]["sent"] += 1
                self._counts[pi][cls] += 1

    def _replay(self, schedule: list) -> None:
        for t, model, size in schedule:
            delay = self._t0 + t - time.perf_counter()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            self._pool.submit(self._job, t, model, size)

    # -- refereeing --------------------------------------------------------
    def _snapshot(self) -> dict:
        win = self.router.window_stats(max(2.0 * self.spec.interval_s, 1.0))
        st = self.router.stats()
        return {
            "schema": SNAPSHOT_SCHEMA,
            "steps": 0,
            "totals": {"steps": int(st.get("requests", 0))},
            "compiles": {"count": 0},
            "events": {"stall": 0, "nonfinite": 0},
            "serve": {
                "p50_ms": float(win.get("p50_ms", 0.0)),
                "p99_ms": float(win.get("p99_ms", 0.0)),
                "window_samples": int(win.get("samples", 0)),
                "queue_depth": int(win.get("queue_depth", 0)),
                "rejected": int(st.get("rejected", 0)),
                "degraded": int(st.get("degraded", 0)),
                # worst traced samples of the window: the rule engine
                # copies these ids onto p99-breach / backpressure alerts
                # as exemplar_trace_ids
                "exemplars": win.get("exemplars", []),
                "models": win.get("models", {}),
            },
        }

    def _probe_logits(self, model: str):
        frame = protocol.model_envelope(model, self._payload_for(model))
        resp = self.router.dispatch(frame)
        if resp.startswith(b'{"error"'):
            return None
        return json.loads(resp).get("logits")

    def _run_update(self, phase: dsl.PhaseSpec, rec: dict) -> None:
        upd = dict(phase.update or {})
        model = upd.get("model")
        overrides = upd.get("overrides") or {}
        before = self._probe_logits(model)
        failed_before = self._counts_total("failed")
        try:
            self.fleet.rolling_update(model, overrides, wait=True)
            rec["ok"] = self.router.n_routable() >= 1
        except Exception as e:  # noqa: BLE001 — scored, not fatal
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
        after = self._probe_logits(model)
        rec.update(
            model=model,
            overrides=overrides,
            logits_changed=(
                before is not None and after is not None and before != after
            ),
            failed_during=self._counts_total("failed") - failed_before,
        )

    def _counts_total(self, key: str) -> int:
        with self._lock:
            return sum(c[key] for c in self._counts)

    def _lag_ms(self, pi: int) -> dict:
        with self._lock:
            lags = sorted(self._lags[pi])
        return {
            "n": len(lags),
            "p50": round(percentile(lags, 0.50) * 1e3, 3),
            "p99": round(percentile(lags, 0.99) * 1e3, 3),
        }

    # -- the campaign ------------------------------------------------------
    def run(self) -> dict:
        """Replay every phase; returns the campaign verdict dict."""
        from distribuuuu_tpu_torch.telemetry import spans

        spec = self.spec
        schedule = dsl.build_schedule(spec)
        sched_hash = dsl.schedule_hash(schedule)
        self.logger.info(
            "campaign %s: %d requests over %.0fs (seed %d, hash %s)",
            spec.name, len(schedule), spec.duration_s, spec.seed,
            sched_hash[:12],
        )
        self._t0 = time.perf_counter()
        replayer = threading.Thread(
            target=self._replay, args=(schedule,), daemon=True,
            name="campaign-replay",
        )
        replayer.start()

        phases = []
        for pi, phase in enumerate(spec.phases):
            engine = RuleEngine(
                [AlertRule(dict(r)) for r in spec.rules], spec.interval_s
            )
            raised: set = set()
            alerts: list = []
            degraded_at_start = int(
                self.router.stats().get("degraded", 0)
            )
            update_rec: dict | None = None
            update_thread = None
            if phase.kind == "rolling_update":
                update_rec = {}
                delay = phase.at_frac * phase.duration_s

                def trigger(rec=update_rec, delay=delay, ph=phase):
                    if not self._stop.wait(delay):
                        self._run_update(ph, rec)

                update_thread = threading.Thread(
                    target=trigger, daemon=True, name="campaign-update"
                )
                update_thread.start()

            t_end = self._t0 + self._bounds[pi][1]
            while not self._stop.is_set():
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    # a rolling update may outlive its phase clock (warm-up
                    # gated respawn); keep refereeing until it lands
                    if update_thread is None or not update_thread.is_alive():
                        break
                self._stop.wait(min(spec.interval_s, max(remaining, 0.05)))
                snap = self._snapshot()
                for alert in engine.evaluate(snap):
                    raised.add(alert["rule"])
                    alerts.append(alert)
            if update_thread is not None:
                update_thread.join(timeout=120)

            snap = self._snapshot()
            with self._lock:
                counts = dict(self._counts[pi])
            ok = raised == set(phase.expect)
            if update_rec is not None:
                ok = ok and bool(update_rec.get("ok")) and bool(
                    update_rec.get("logits_changed")
                )
            rec = {
                "name": phase.name,
                "kind": phase.kind,
                "duration_s": phase.duration_s,
                "expected": sorted(phase.expect),
                "raised": sorted(raised),
                "ok": ok,
                "counts": counts,
                "degraded_delta": int(
                    snap["serve"]["degraded"] - degraded_at_start
                ),
                "p99_ms_end": snap["serve"]["p99_ms"],
                "send_lag_ms": self._lag_ms(pi),
                "alerts": alerts,
            }
            if update_rec is not None:
                rec["update"] = update_rec
            phases.append(rec)
            spans.emit_event(
                "campaign.phase",
                campaign=spec.name,
                phase=phase.name,
                expected_alerts=rec["expected"],
                raised_alerts=rec["raised"],
                ok=rec["ok"],
            )
            self.logger.info(
                "campaign %s phase %s: expected=%s raised=%s ok=%s %s lag %s",
                spec.name, phase.name, rec["expected"], rec["raised"],
                rec["ok"], counts, rec["send_lag_ms"],
            )

        self._stop.set()
        replayer.join(timeout=10)
        self._pool.shutdown(wait=True)
        # a phase's last jobs may finish after its record was written:
        # recount once every job has finished
        for pi, rec in enumerate(phases):
            with self._lock:
                rec["counts"] = dict(self._counts[pi])
            rec["send_lag_ms"] = self._lag_ms(pi)

        alerts_exact = all(p["ok"] for p in phases)
        control_clean = all(
            not p["raised"] for p in phases if not p["expected"]
        )
        st = self.router.stats()
        verdict = {
            "campaign": spec.name,
            "seed": spec.seed,
            "interval_s": spec.interval_s,
            "schedule_hash": sched_hash,
            "requests_scheduled": len(schedule),
            "phases": phases,
            "models": st.get("models", {}),
            "alerts_exact": alerts_exact,
            "control_clean": control_clean,
            "ok": alerts_exact and control_clean,
        }
        if st.get("length_classes"):
            # length-aware fleet: the per-class admission and latency
            # ledger is the verdict's starvation evidence
            verdict["length_classes"] = st["length_classes"]
            verdict["long_prompt_threshold"] = st.get(
                "long_prompt_threshold"
            )
        spans.emit_event(
            "campaign.verdict",
            campaign=spec.name,
            phases=len(phases),
            alerts_exact=alerts_exact,
            control_clean=control_clean,
            ok=verdict["ok"],
        )
        return verdict

    def stop(self) -> None:
        self._stop.set()
