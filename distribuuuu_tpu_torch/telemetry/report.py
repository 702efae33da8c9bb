"""Run health + regression report from a finished run's telemetry: the
port's own copy of ``build_report``, ``comparable_metrics`` and
``compare`` of ``tools/run_report.py`` (which imports the JAX package),
with the parts of ``tools/overlap_report.py`` and
``tools/trace_request.py`` they read. The same report, key for key, on
the same run directory (tests/test_torch_live.py holds the two against
each other on a port run).

``build_report(run_dir)`` merges the per-rank telemetry files
(``{run}/telemetry/rank*.jsonl``) with the primary ``metrics.jsonl``:
cross-rank step time and straggler skew, data-wait fraction, resilience
events, graph captures (``compile`` records), checkpoint costs, the
FLOP/byte ledger's MFU and memory headroom, and the LM, campaign, kernel
and request-trace sections. ``compare(current, baseline, tol_pct,
overrides)`` is the direction-aware regression gate the soak referee
evaluates per interval (``soak.py``).
"""

from __future__ import annotations

import os

from distribuuuu_tpu_torch.telemetry import export
from distribuuuu_tpu_torch.telemetry.registry import percentile

REPORT_SCHEMA = 1

# direction-aware comparison sets: a metric is a regression when it moves
# the WRONG way by more than its tolerance
LOWER_BETTER = (
    "step_ms_p50", "step_ms_p90", "step_ms_p99", "data_wait_frac",
    "straggler_skew", "recompiles", "ckpt_save_max_s",
)
HIGHER_BETTER = ("img_per_sec", "mfu", "hbm_headroom_pct")


# -- timeline attribution (tools/overlap_report.py) ------------------------
def _union_len(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [a, b] intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _attribute(recs: list[dict], phase: str = "train",
               epoch: int | None = None) -> dict:
    """Attribution over one phase (and optionally one epoch) of timeline
    records. ``epoch=None`` selects the LAST epoch present — the steady
    state (earlier epochs pay compile). Raises ValueError when no records
    match (e.g. a folded-dispatch run, which emits none)."""
    recs = [r for r in recs if r.get("phase") == phase]
    if epoch is None and recs:
        epoch = max(r["epoch"] for r in recs)
    recs = [r for r in recs if r.get("epoch") == epoch]
    if not recs:
        raise ValueError(
            f"no timeline records for phase={phase!r} epoch={epoch!r} — "
            "was the run folded (TRAIN.STEPS_PER_CALL > 1) or "
            "TRAIN.TIMELINE off?"
        )
    recs = sorted(recs, key=lambda r: r["batch"])
    wall = max(r["step1"] for r in recs) - min(r["get0"] for r in recs)
    wall = max(wall, 1e-9)
    data_wait = sum(r["get1"] - r["get0"] for r in recs)
    h2d = sum(r["put1"] - r["put0"] for r in recs)
    step = sum(r["step1"] - r["step0"] for r in recs)
    other = wall - data_wait - h2d - step  # exact residual, ≥ 0 up to clock
    has_dec = all("dec0" in r and "asm1" in r for r in recs)
    decode = sum(r["dec1"] - r["dec0"] for r in recs) if has_dec else 0.0
    assemble = sum(r["asm1"] - r["dec1"] for r in recs) if has_dec else 0.0
    decode_busy = (
        _union_len([(r["dec0"], r["asm1"]) for r in recs]) if has_dec else 0.0
    )
    images = sum(r.get("n", 0) for r in recs)
    out = {
        "phase": phase,
        "epoch": epoch,
        "n_batches": len(recs),
        "images": images,
        "wall_s": round(wall, 4),
        "img_per_sec": round(images / wall, 2),
        # the exact partition (sums to wall_s by construction)
        "data_wait_s": round(data_wait, 4),
        "h2d_s": round(h2d, 4),
        "step_s": round(step, 4),
        "other_s": round(other, 4),
        # worker-side, overlapped
        "decode_s": round(decode, 4),
        "assemble_s": round(assemble, 4),
        "decode_busy_s": round(decode_busy, 4),
        # headline ratios, from measured intervals
        "data_wait_frac": round(data_wait / wall, 4),
        "overlap_efficiency": round(min(1.0, decode_busy / wall), 4),
        # partition self-check: |sum(components) - wall| / wall — exactly 0
        # up to the rounding above (the acceptance gate is ≤ 0.05)
        "attribution_residual_frac": round(
            abs(data_wait + h2d + step + other - wall) / wall, 6
        ),
    }
    return out



# -- the request-trace breakdown (tools/trace_request.py) ------------------
# span name -> stage bucket (wall-clock residency attribution: a traced
# request resident in a batched decode step owns that step's full
# duration, so per-request stage sums approximate the router-observed
# latency — the TRACE_r01.json tolerance check)
STAGE_BUCKETS = ("queue", "prefill", "decode", "speculation")
_STAGE_OF = {
    "queue_wait": "queue",
    "prefill": "prefill",
    "chunk_prefill": "prefill",
    "decode_step": "decode",
    "spec_round": "speculation",
}
# total-latency source, most authoritative first: the router saw the
# whole hop; the client edge includes its own socket; the engine span
# excludes router queueing
_TOTAL_PREFERENCE = ("router.dispatch", "client.request", "engine.request")

_META_KEYS = frozenset({
    "kind", "rank", "t", "v", "trace", "span", "parent", "name",
    "t0", "dur", "t0_unix",
})


def collect_traces(run_dir: str) -> dict[str, list[dict]]:
    """{trace_id: [span records]} across ALL rank files — the top-level
    telemetry dir AND the fleet's nested per-model replica dirs
    (``model_*/telemetry``) — each span annotated with its emitting
    ``rank`` label and anchor-mapped ``t0_unix`` (spans per trace sorted
    by wall-clock start)."""
    traces: dict[str, list[dict]] = {}
    for _pid, label, path in export.fleet_rank_files(run_dir):
        recs = export.read_jsonl(path)
        anc = export._anchor(recs)
        for r in recs:
            if r.get("kind") != "trace.span":
                continue
            s = dict(r)
            s["rank"] = label
            t0 = float(r["t0"])
            s["t0_unix"] = (anc[0] + (t0 - anc[1])) if anc else t0
            traces.setdefault(str(r["trace"]), []).append(s)
    for spans in traces.values():
        spans.sort(key=lambda s: s["t0_unix"])
    return traces


def is_connected(spans: list[dict]) -> bool:
    """Every span's parent is either "" (a root) or another span of the
    SAME trace — i.e. the cross-process tree reassembled with no orphans
    (the propagation pin tests/test_trace.py asserts on a real fleet)."""
    ids = {s["span"] for s in spans}
    return all((s.get("parent") or "") in ids or not s.get("parent")
               for s in spans)


def stage_shares(spans: list[dict]) -> dict:
    """Per-stage seconds and shares-of-total for one trace. ``total_ms``
    comes from the most authoritative root span present (router >
    client edge > engine); shares are empty when no root was captured
    (e.g. a trace torn mid-run)."""
    sums = dict.fromkeys(STAGE_BUCKETS, 0.0)
    for s in spans:
        b = _STAGE_OF.get(str(s.get("name")))
        if b:
            sums[b] += float(s["dur"])
    total_s = None
    src = None
    for name in _TOTAL_PREFERENCE:
        root = next((s for s in spans if s["name"] == name), None)
        if root is not None:
            total_s, src = float(root["dur"]), name
            break
    eng = next((s for s in spans if s["name"] == "engine.request"), None)
    return {
        "total_ms": None if total_s is None else round(total_s * 1e3, 3),
        "total_source": src,
        "stage_ms": {k: round(v * 1e3, 3) for k, v in sums.items()},
        "stage_sum_ms": round(sum(sums.values()) * 1e3, 3),
        "shares": (
            {k: round(v / total_s, 4) for k, v in sums.items()}
            if total_s else {}
        ),
        "length_class": None if eng is None else eng.get("length_class"),
        "new_tokens": None if eng is None else eng.get("new_tokens"),
        "spans": len(spans),
    }


def breakdown_by_class(traces: dict[str, list[dict]]) -> dict | None:
    """p50/p99 of total latency and of each stage's share, per length
    class — run_report.py's per-request latency-breakdown section.
    None when the run holds no complete traces."""
    shares: dict[str, dict[str, list[float]]] = {}
    totals: dict[str, list[float]] = {}
    for spans in traces.values():
        sh = stage_shares(spans)
        if sh["total_ms"] is None:
            continue
        lc = str(sh["length_class"] or "unknown")
        cls = shares.setdefault(lc, {k: [] for k in STAGE_BUCKETS})
        for k in STAGE_BUCKETS:
            cls[k].append(sh["shares"].get(k, 0.0))
        totals.setdefault(lc, []).append(sh["total_ms"])
    if not totals:
        return None
    out = {}
    for lc in sorted(totals):
        t = sorted(totals[lc])
        row = {
            "requests": len(t),
            "total_ms_p50": round(percentile(t, 0.50), 3),
            "total_ms_p99": round(percentile(t, 0.99), 3),
            "shares": {},
        }
        for k in STAGE_BUCKETS:
            vals = sorted(shares[lc][k])
            row["shares"][k] = {
                "p50": round(percentile(vals, 0.50), 4),
                "p99": round(percentile(vals, 0.99), 4),
            }
        out[lc] = row
    return out




def _load_ranks(run_dir: str) -> dict[int, list[dict]]:
    return {
        rank: export.read_jsonl(path)
        for rank, path in export.rank_files(run_dir).items()
    }


def _spans(recs: list[dict], name: str, phase: str | None = None) -> list[dict]:
    out = []
    for r in recs:
        if r.get("kind") != "span" or r.get("name") != name:
            continue
        if phase is not None and r.get("phase") != phase:
            continue
        out.append(r)
    return out


def _step_durs(recs: list[dict], phase: str) -> tuple[list[float], str]:
    """Per-step durations (seconds) for one rank: ``step`` spans when the
    run dispatched per-step; ``fold_window`` spans ÷ steps otherwise."""
    steps = _spans(recs, "step", phase)
    if steps:
        return [float(r["dur"]) for r in steps], "step"
    folds = _spans(recs, "fold_window", phase)
    return (
        [float(r["dur"]) / max(1, int(r.get("n", 1))) for r in folds],
        "fold_window",
    )


def _summary_ms(durs: list[float]) -> dict:
    vals = sorted(durs)
    ms = 1e3
    return {
        "count": len(vals),
        "mean_ms": round(sum(vals) / len(vals) * ms, 3) if vals else 0.0,
        "p50_ms": round(percentile(vals, 0.50) * ms, 3),
        "p90_ms": round(percentile(vals, 0.90) * ms, 3),
        "p99_ms": round(percentile(vals, 0.99) * ms, 3),
        "max_ms": round(vals[-1] * ms, 3) if vals else 0.0,
    }


def _wait_frac_from_spans(recs: list[dict], phase: str) -> float | None:
    """Fallback data-wait fraction for one rank: wait seconds over the
    pipeline-track wall (first span start → last span end)."""
    pipeline = [
        r for r in recs
        if r.get("kind") == "span" and r.get("track") == "pipeline"
        and (r.get("phase") == phase)
    ]
    if not pipeline:
        return None
    t0 = min(float(r["t0"]) for r in pipeline)
    t1 = max(float(r["t0"]) + float(r["dur"]) for r in pipeline)
    wall = max(t1 - t0, 1e-9)
    wait = sum(float(r["dur"]) for r in pipeline if r.get("name") == "wait")
    return wait / wall


def _cost_section(ranks: dict[int, list[dict]], phase: str,
                  mean_step_s: float | None) -> dict | None:
    """The MFU / roofline / HBM-headroom section from the cost-model
    ledger records (telemetry/costmodel.py emits them once per step
    program; the latest phase-matching record wins). Measured MFU =
    ledger flops/step ÷ measured mean step time ÷ device peak (the peak
    is in the record).
    ``source`` is "xla" or the flagged "analytic" fallback."""
    step_rec = roof_rec = None
    mem_recs: dict[str, dict] = {}
    for recs in ranks.values():
        for r in recs:
            kind = r.get("kind")
            if kind == "cost.step" and r.get("phase") == phase:
                step_rec = r
            elif kind == "cost.roofline" and r.get("phase") == phase:
                roof_rec = r
            elif kind == "cost.memory":
                mem_recs[str(r.get("label"))] = r
    if step_rec is None and not mem_recs:
        return None
    out = {
        "source": step_rec.get("source") if step_rec else None,
        "flops_per_step": step_rec.get("flops") if step_rec else None,
        "bytes_per_step": step_rec.get("bytes_accessed") if step_rec else None,
        "images_per_step": step_rec.get("images") if step_rec else None,
        "device_kind": step_rec.get("device_kind") if step_rec else None,
        "peak_flops": step_rec.get("peak_flops") if step_rec else None,
        "mfu": None,
        "roofline": None,
        "hbm": None,
    }
    if (
        step_rec and step_rec.get("flops") and step_rec.get("peak_flops")
        and mean_step_s
    ):
        out["mfu"] = round(
            float(step_rec["flops"]) / mean_step_s
            / float(step_rec["peak_flops"]), 4
        )
    if roof_rec is not None:
        out["roofline"] = {
            "arithmetic_intensity": roof_rec.get("arithmetic_intensity"),
            "ridge_intensity": roof_rec.get("ridge_intensity"),
            "bound": roof_rec.get("bound"),
            "nominal_peaks": roof_rec.get("nominal_peaks"),
        }
    if mem_recs:
        per_label = {
            label: {
                "total_bytes": r.get("total_bytes"),
                "capacity_bytes": r.get("capacity_bytes"),
                "headroom_pct": r.get("headroom_pct"),
            }
            for label, r in sorted(mem_recs.items())
        }
        headrooms = [
            v["headroom_pct"] for v in per_label.values()
            if v["headroom_pct"] is not None
        ]
        out["hbm"] = {
            "per_executable": per_label,
            "headroom_pct": min(headrooms) if headrooms else None,
            "capacity_source": next(iter(mem_recs.values())).get(
                "capacity_source"
            ),
        }
    return out


def _count_events(ranks: dict[int, list[dict]], metrics: list[dict]) -> dict:
    """stall/data_error/nonfinite tallies. Rank files carry every record
    (jsonlog mirrors into them), so they are authoritative when present;
    a telemetry-off run falls back to the primary metrics.jsonl (which
    only ever saw rank 0)."""
    kinds = ("stall", "data_error", "nonfinite")
    out = {k: 0 for k in kinds}
    source = ranks.values() if ranks else [metrics]
    for recs in source:
        for r in recs:
            if r.get("kind") in kinds:
                out[r["kind"]] += 1
    return out


def _lm_section(ranks: dict[int, list[dict]]) -> dict | None:
    """The LM workload plane (lm/generate.py): generation tokens/s from
    the cumulative ``lm.tokens`` counters (last record per rank wins) and
    prefill/decode latency percentiles from the per-step ``gen.*``
    records. None when the run has no
    LM records (image runs are untouched)."""
    last_tokens: dict[int, dict] = {}
    dec_ms: list[float] = []
    pre_ms: list[float] = []
    chunk_ms: list[float] = []
    chunk_calls = 0
    admits = retires = 0
    reasons: dict[str, int] = {}
    admit_classes: dict[str, int] = {}
    spec_rounds = spec_proposed = spec_accepted = spec_bonus = 0
    for rank, recs in sorted(ranks.items()):
        for r in recs:
            kind = r.get("kind")
            if kind == "lm.tokens":
                last_tokens[rank] = r
            elif kind == "gen.decode":
                dec_ms.append(float(r["ms"]))
            elif kind == "gen.prefill":
                pre_ms.append(float(r["ms"]))
            elif kind == "gen.chunk_prefill":
                chunk_ms.append(float(r["ms"]))
                chunk_calls += int(r.get("chunks", 0))
            elif kind == "gen.admit":
                admits += 1
                lc = r.get("length_class")
                if lc:
                    admit_classes[str(lc)] = admit_classes.get(str(lc), 0) + 1
            elif kind == "gen.retire":
                retires += 1
                reason = str(r.get("reason"))
                reasons[reason] = reasons.get(reason, 0) + 1
            elif kind == "gen.speculate":
                spec_rounds += 1
                spec_proposed += int(r.get("proposed", 0))
                spec_accepted += int(r.get("accepted", 0))
                spec_bonus += int(r.get("bonus", 0))
    if not (last_tokens or dec_ms or pre_ms):
        return None
    new_tokens = sum(int(r.get("new_tokens", 0)) for r in last_tokens.values())
    prompt_tokens = sum(
        int(r.get("prompt_tokens", 0)) for r in last_tokens.values()
    )
    decode_steps = sum(
        int(r.get("decode_steps", 0)) for r in last_tokens.values()
    )
    tokens_per_s = round(sum(
        int(r.get("new_tokens", 0)) / max(float(r.get("elapsed_s", 0.0)), 1e-9)
        for r in last_tokens.values()
    ), 3) if last_tokens else None
    out = {
        "prompt_tokens": prompt_tokens,
        "new_tokens": new_tokens,
        "decode_steps": decode_steps,
        "tokens_per_s": tokens_per_s,
        "admits": admits,
        "retires": retires,
        "retire_reasons": reasons,
        "decode": _summary_ms([v / 1e3 for v in dec_ms]),
        "prefill": _summary_ms([v / 1e3 for v in pre_ms]),
    }
    if chunk_ms:
        # chunked paged prefill: per-prompt wall + total
        # fixed-width chunk appends — the long-context admission path
        out["chunk_prefill"] = {
            "prompts": len(chunk_ms),
            "chunk_calls": chunk_calls,
            **_summary_ms([v / 1e3 for v in chunk_ms]),
        }
    if admit_classes:
        out["admit_length_classes"] = admit_classes
    if spec_rounds:
        # acceptance ratio = accepted/proposed (draft quality); tokens
        # per round = (accepted+bonus+rejections-resampled)/rounds — the
        # roofline win condition is emitted tokens/round > 1
        out["speculate"] = {
            "rounds": spec_rounds,
            "proposed": spec_proposed,
            "accepted": spec_accepted,
            "bonus": spec_bonus,
            "acceptance_ratio": round(
                spec_accepted / max(spec_proposed, 1), 4
            ),
            "accepted_per_round": round(
                (spec_accepted + spec_bonus) / spec_rounds, 3
            ),
        }
    return out


def _trace_section(run_dir: str, ranks: dict[int, list[dict]]) -> dict | None:
    """The request-tracing plane: per-length-class p50/p99 of
    total latency and of each stage's SHARE of it (queue wait, prefill,
    decode residency, speculation), computed from the ``trace.span``
    records ``collect_traces`` reassembles. The share percentiles
    answer "where do slow requests spend their time" without opening a
    single waterfall. None when the run was untraced."""
    if not any(
        r.get("kind") == "trace.span" for recs in ranks.values()
        for r in recs
    ):
        return None
    traces = collect_traces(run_dir)
    breakdown = breakdown_by_class(traces)
    exemplars = sorted(
        {
            str(r.get("trace")) for recs in ranks.values() for r in recs
            if r.get("kind") == "trace.exemplar"
        }
    )
    return {
        "requests": len(traces),
        "connected": sum(
            1 for spans in traces.values()
            if is_connected(spans)
        ),
        "by_length_class": breakdown,
        "exemplar_trace_ids": exemplars or None,
    }


def _campaign_section(ranks: dict[int, list[dict]]) -> dict | None:
    """The traffic-campaign plane (serve/campaign/): per-campaign verdicts
    (``campaign.verdict``), per-phase expected-vs-raised alert gates
    (``campaign.phase``), per-model routing totals on multi-model fleets
    (``fleet.model_route``, last record per model wins), per-length-class
    routing totals on length-aware fleets (``fleet.length_class``,
    and any quantized engine starts (``serve.quantized``).
    None when the run carried no campaign records (training and plain
    serve runs are untouched)."""
    phases: list[dict] = []
    verdicts: list[dict] = []
    model_route: dict[str, dict] = {}
    length_classes: dict[str, dict] = {}
    quantized: list[dict] = []
    for recs in ranks.values():
        for r in recs:
            kind = r.get("kind")
            if kind == "campaign.phase":
                phases.append({
                    "campaign": r.get("campaign"), "phase": r.get("phase"),
                    "expected_alerts": r.get("expected_alerts"),
                    "raised_alerts": r.get("raised_alerts"),
                    "ok": r.get("ok"),
                })
            elif kind == "campaign.verdict":
                verdicts.append({
                    "campaign": r.get("campaign"),
                    "phases": r.get("phases"),
                    "alerts_exact": r.get("alerts_exact"),
                    "control_clean": r.get("control_clean"),
                    "ok": r.get("ok"),
                })
            elif kind == "fleet.model_route":
                model_route[str(r.get("model"))] = {
                    "requests": r.get("requests"),
                    "rejected": r.get("rejected"),
                    "degraded_in": r.get("degraded_in"),
                    "degraded_out": r.get("degraded_out"),
                    "p99_ms": r.get("p99_ms"),
                }
            elif kind == "fleet.length_class":
                # length-aware routing: last record per class
                # wins — the long-vs-short admission/latency evidence
                length_classes[str(r.get("length_class"))] = {
                    "threshold": r.get("threshold"),
                    "requests": r.get("requests"),
                    "rejected": r.get("rejected"),
                    "p99_ms": r.get("p99_ms"),
                }
            elif kind == "serve.quantized":
                quantized.append({
                    "arch": r.get("arch"), "mode": r.get("mode"),
                    "bytes_before": r.get("bytes_before"),
                    "bytes_after": r.get("bytes_after"),
                })
    if not (phases or verdicts or model_route or length_classes
            or quantized):
        return None
    return {
        "campaigns": len(verdicts),
        "ok": all(v["ok"] for v in verdicts) if verdicts else None,
        "verdicts": verdicts,
        "phases": phases,
        "model_route": model_route or None,
        "length_classes": length_classes or None,
        "quantized": quantized or None,
    }


def _kernels_section(ranks: dict[int, list[dict]]) -> dict | None:
    """The kernel tier (ops/cuda/ in the port): which impl actually ran
    per op (``kernel.select``), every forced-but-unsupported fallback with
    its reason (``kernel.fallback``), and — when the run carried
    ``kernel_*``-labeled cost records
    — the per-kernel A/B deltas. None when the run never consulted the
    tier (pre-tier runs are untouched)."""
    selected: dict[str, dict] = {}
    fallbacks: list[dict] = []
    ab: dict[str, dict] = {}
    for recs in ranks.values():
        for r in recs:
            kind = r.get("kind")
            if kind == "kernel.select":
                op = str(r.get("op"))
                selected[op] = {
                    "impl": r.get("impl"), "requested": r.get("requested"),
                }
            elif kind == "kernel.fallback":
                fallbacks.append({
                    "op": r.get("op"), "requested": r.get("requested"),
                    "reason": r.get("reason"),
                })
            elif kind == "cost.step" and str(r.get("label", "")).startswith(
                "kernel_"
            ):
                ab[str(r["label"])] = {
                    "flops": r.get("flops"),
                    "bytes_accessed": r.get("bytes_accessed"),
                }
    if not (selected or fallbacks):
        return None
    return {
        "selected": selected,
        "fallbacks": fallbacks,
        "ab": ab or None,
    }


def build_report(run_dir: str, phase: str = "train") -> dict:
    ranks = _load_ranks(run_dir)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    metrics = export.read_jsonl(metrics_path) if os.path.exists(metrics_path) else []
    if not ranks and not metrics:
        raise FileNotFoundError(
            f"no telemetry under {run_dir}: expected telemetry/rank*.jsonl "
            "(TELEMETRY.ENABLED) and/or metrics.jsonl"
        )

    # -- cross-rank step time + straggler skew ---------------------------
    per_rank, pooled, source = {}, [], "step"
    for rank, recs in sorted(ranks.items()):
        durs, src = _step_durs(recs, phase)
        if not durs:
            continue
        source = src
        per_rank[str(rank)] = _summary_ms(durs)
        pooled.extend(durs)
    rank_p50s = [s["p50_ms"] for s in per_rank.values() if s["count"]]
    straggler = (
        round(max(rank_p50s) / max(min(rank_p50s), 1e-9), 4)
        if len(rank_p50s) >= 2 else 1.0
    )

    # -- data-wait fraction + throughput ---------------------------------
    data_wait_frac = None
    img_per_sec = None
    timeline = [r for r in metrics if r.get("kind") == "timeline"]
    if timeline:
        try:
            att = _attribute(timeline, phase=phase)
            data_wait_frac = att["data_wait_frac"]
            img_per_sec = att["img_per_sec"]
        except ValueError:
            pass
    if data_wait_frac is None:
        fracs = [
            f for f in (
                _wait_frac_from_spans(recs, phase) for recs in ranks.values()
            ) if f is not None
        ]
        if fracs:
            data_wait_frac = round(sum(fracs) / len(fracs), 4)

    # -- dispatch sequencer (asyncplane/sequencer.py) --------------------
    # running aggregates: the LAST dispatch.token record per rank wins;
    # dispatch.wedge flags are counted outright
    seq_last: dict[int, dict] = {}
    ring_last: dict[str, dict] = {}
    wedges = 0
    barrier_waits: dict[str, list[float]] = {}
    shard_recs: dict[str, list[dict]] = {}
    for rank, recs in sorted(ranks.items()):
        for r in recs:
            kind = r.get("kind")
            if kind == "dispatch.token":
                seq_last[rank] = r
            elif kind == "dispatch.ring":
                ring_last[str(r.get("host", rank))] = r
            elif kind == "dispatch.wedge":
                wedges += 1
            elif kind == "ckpt.barrier":
                barrier_waits.setdefault(
                    str(r.get("host", rank)), []
                ).append(float(r.get("wait_s", 0.0)))
            elif kind == "ckpt.shard":
                shard_recs.setdefault(
                    str(r.get("host", rank)), []
                ).append(r)
    sequencer = None
    if seq_last:
        sequencer = {
            "tokens": sum(int(s.get("tokens", 0)) for s in seq_last.values()),
            "streams": {
                k: v for s in seq_last.values()
                for k, v in (s.get("streams") or {}).items()
            },
            "max_wait_s": max(
                float(s.get("max_wait_s", 0.0)) for s in seq_last.values()
            ),
            "total_wait_s": round(sum(
                float(s.get("total_wait_s", 0.0)) for s in seq_last.values()
            ), 6),
            "fence_waits": sum(
                int(s.get("fence_waits", 0)) for s in seq_last.values()
            ),
            "fence_wait_s": round(sum(
                float(s.get("fence_wait_s", 0.0)) for s in seq_last.values()
            ), 6),
            "wedges": wedges,
        }
        # cross-host dispatch ring (asyncplane/ring.py, multi-host runs):
        # the LAST dispatch.ring record per host — per-host slot counts
        # and ring waits, plus the wedge/detach degradation flags
        if ring_last:
            sequencer["ring"] = {
                "hosts": len(ring_last),
                "per_host": {
                    host: {
                        "role": r.get("role"),
                        "slots": int(r.get("slots", 0)),
                        "total_wait_s": round(
                            float(r.get("total_wait_s", 0.0)), 6
                        ),
                        "max_wait_s": round(
                            float(r.get("max_wait_s", 0.0)), 6
                        ),
                        "deadline_misses": int(r.get("deadline_misses", 0)),
                        "wedged": bool(r.get("wedged", False)),
                        "detached": bool(r.get("detached", False)),
                    }
                    for host, r in sorted(ring_last.items())
                },
            }

    # -- recompiles / checkpoints / resilience events --------------------
    compiles = {"count": 0, "wall_s": 0.0}
    cache = {"hits": 0, "misses": 0}
    ckpt = {"saves": 0, "save_mean_s": 0.0, "save_max_s": 0.0,
            "restores": 0, "restore_mean_s": 0.0,
            "snapshots": 0, "snapshot_mean_s": 0.0, "snapshot_max_s": 0.0,
            "commits": 0, "commit_mean_s": 0.0, "commit_max_s": 0.0,
            "on_path_s": 0.0, "off_path_s": 0.0}
    saves, restores, snaps, commits = [], [], [], []
    for recs in ranks.values():
        for r in recs:
            if r.get("kind") == "compile":
                compiles["count"] += 1
                compiles["wall_s"] += float(r["dur_s"])
            elif r.get("kind") == "compile.cache":
                if r.get("event") == "hit":
                    cache["hits"] += 1
                elif r.get("event") == "miss":
                    cache["misses"] += 1
        saves += [float(r["dur"]) for r in _spans(recs, "ckpt_save")]
        restores += [float(r["dur"]) for r in _spans(recs, "ckpt_restore")]
        snaps += [float(r["dur"]) for r in _spans(recs, "ckpt_snapshot")]
        commits += [float(r["dur"]) for r in _spans(recs, "ckpt_commit")]
    compiles["wall_s"] = round(compiles["wall_s"], 3)
    if saves:
        ckpt.update(saves=len(saves),
                    save_mean_s=round(sum(saves) / len(saves), 3),
                    save_max_s=round(max(saves), 3))
    if restores:
        ckpt.update(restores=len(restores),
                    restore_mean_s=round(sum(restores) / len(restores), 3))
    # async checkpointing (CHECKPOINT.ASYNC): the trainer blocks only for
    # the snapshot spans; commit spans run on the background committer —
    # on_path vs off_path is the headline the async plane is gated on
    if snaps:
        ckpt.update(snapshots=len(snaps),
                    snapshot_mean_s=round(sum(snaps) / len(snaps), 6),
                    snapshot_max_s=round(max(snaps), 6))
    if commits:
        ckpt.update(commits=len(commits),
                    commit_mean_s=round(sum(commits) / len(commits), 6),
                    commit_max_s=round(max(commits), 6))
    ckpt["on_path_s"] = round(sum(saves) + sum(snaps), 6)
    ckpt["off_path_s"] = round(sum(commits), 6)
    # multi-host async commit: the cross-host barrier wait per host
    # (ckpt.barrier records — asyncplane/committer.py multihost_commit)
    if barrier_waits:
        ckpt["barrier"] = {
            "hosts": len(barrier_waits),
            "per_host": {
                host: {
                    "saves": len(ws),
                    "mean_wait_s": round(sum(ws) / len(ws), 6),
                    "max_wait_s": round(max(ws), 6),
                }
                for host, ws in sorted(barrier_waits.items())
            },
        }
    # sharded multi-host saves (ckpt.shard records — utils/checkpoint.py
    # _save_sharded): each host writes its OWN shards; per-host commit cost
    if shard_recs:
        ckpt["shards"] = {
            "hosts": len(shard_recs),
            "per_host": {
                host: {
                    "saves": len(rs),
                    "shards": int(rs[-1].get("shards", 0)),
                    "bytes": int(rs[-1].get("bytes", 0)),
                    "mean_write_s": round(
                        sum(float(r.get("write_s", 0.0)) for r in rs)
                        / len(rs), 6,
                    ),
                    "max_write_s": round(
                        max(float(r.get("write_s", 0.0)) for r in rs), 6
                    ),
                }
                for host, rs in sorted(shard_recs.items())
            },
        }

    step_summary = _summary_ms(pooled)
    mean_step_s = (
        step_summary["mean_ms"] / 1e3 if step_summary["count"] else None
    )
    report = {
        "schema": REPORT_SCHEMA,
        "run_dir": os.path.abspath(run_dir),
        "phase": phase,
        "n_ranks": len(ranks),
        "step_source": source,
        "step": step_summary,
        "per_rank_step": per_rank,
        "straggler_skew": straggler,
        "data_wait_frac": data_wait_frac,
        "img_per_sec": img_per_sec,
        "cost": _cost_section(ranks, phase, mean_step_s),
        "events": _count_events(ranks, metrics),
        "recompiles": compiles,
        "compile_cache": cache if (cache["hits"] or cache["misses"]) else None,
        "checkpoint": ckpt,
        "sequencer": sequencer,
        "lm": _lm_section(ranks),
        "kernels": _kernels_section(ranks),
        "campaign": _campaign_section(ranks),
        "trace": _trace_section(run_dir, ranks),
    }
    return report


# ------------------------------------------------------------- comparison
def comparable_metrics(doc: dict) -> dict:
    """Flatten a baseline/current document into the named comparison
    metrics. Accepts a RUN_REPORT.json (ours), a repo BENCH_*.json
    artifact (``parsed.metric``/``value`` — img/s becomes the throughput
    reference), or a BENCH_INDEX.json trajectory
    (tools/bench_history.py — the LATEST point of each throughput
    series, so the gate tracks the newest committed bench)."""
    out = {}
    if doc.get("bench_index"):
        for metric, points in (doc.get("series") or {}).items():
            if not points or metric.endswith("_vs_baseline"):
                continue  # ratios are derived, not a throughput reference
            if (
                ("images_per_sec" in metric or "img_per_sec" in metric)
                and not metric.endswith("_mfu")  # bench MFU series: a
                # ratio riding the throughput metric's name, not img/s
            ):
                out["img_per_sec"] = float(points[-1]["value"])
            # the cost-model series (tools/bench_history.py folds them in
            # from COSTMODEL_r*.json / bench mfu) gate like throughput
            elif metric == "train_step_mfu":
                out["mfu"] = float(points[-1]["value"])
            elif metric == "train_step_hbm_headroom_pct":
                out["hbm_headroom_pct"] = float(points[-1]["value"])
        return out
    if "step" in doc and isinstance(doc.get("step"), dict):
        for q in ("p50", "p90", "p99"):
            v = doc["step"].get(f"{q}_ms")
            if v:
                out[f"step_ms_{q}"] = float(v)
        if doc.get("straggler_skew") is not None:
            out["straggler_skew"] = float(doc["straggler_skew"])
        if doc.get("data_wait_frac") is not None:
            out["data_wait_frac"] = float(doc["data_wait_frac"])
        if doc.get("img_per_sec"):
            out["img_per_sec"] = float(doc["img_per_sec"])
        rc = doc.get("recompiles", {})
        if rc:
            out["recompiles"] = float(rc.get("count", 0))
        ck = doc.get("checkpoint", {})
        if ck.get("saves"):
            out["ckpt_save_max_s"] = float(ck["save_max_s"])
        cost = doc.get("cost") or {}
        if cost.get("mfu") is not None:
            out["mfu"] = float(cost["mfu"])
        hbm = cost.get("hbm") or {}
        if hbm.get("headroom_pct") is not None:
            out["hbm_headroom_pct"] = float(hbm["headroom_pct"])
    parsed = doc.get("parsed")
    if parsed and "value" in parsed:
        metric = str(parsed.get("metric", ""))
        if "images_per_sec" in metric or "img_per_sec" in metric:
            out["img_per_sec"] = float(parsed["value"])
    return out


def compare(current: dict, baseline: dict, tol_pct: float,
            tol_overrides: dict[str, float]) -> dict:
    """Direction-aware regression check over the metrics both sides
    have. Returns {"ok", "checked", "rows": [...]}; a row FAILs when the
    current value is worse than baseline by more than its tolerance."""
    cur = comparable_metrics(current)
    base = comparable_metrics(baseline)
    rows = []
    for name in sorted(set(cur) & set(base)):
        b, c = base[name], cur[name]
        tol = tol_overrides.get(name, tol_pct)
        delta_pct = (c - b) / abs(b) * 100.0 if b else (100.0 if c else 0.0)
        if name in HIGHER_BETTER:
            ok = c >= b * (1.0 - tol / 100.0)
        else:
            ok = c <= b * (1.0 + tol / 100.0)
        rows.append({
            "metric": name, "baseline": b, "current": c,
            "delta_pct": round(delta_pct, 2), "tol_pct": tol, "ok": ok,
            "direction": "higher" if name in HIGHER_BETTER else "lower",
        })
    return {
        "ok": all(r["ok"] for r in rows),
        "checked": len(rows),
        "rows": rows,
    }


# ---------------------------------------------------------------- output
