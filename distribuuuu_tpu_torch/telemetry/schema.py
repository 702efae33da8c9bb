"""The ``kind=`` schema: every record kind the port emits, through
``utils/jsonlog.metrics_log`` or the per-rank sink, with its required
fields (counterpart of distribuuuu_tpu/telemetry/schema.py; each kind
here has the JAX package's required fields exactly, and the port declares
no kind the JAX package lacks).

Required means what consumers (``telemetry/export.py``,
``tools/run_report.py``) read; an emitter may add free-form fields. The
port's meaning of a kind, where it differs from XLA's:

* ``compile``: one CUDA graph capture (``graphs.StepGraph``; ``event``
  ``"cuda_graph_capture"``, ``dur_s`` its warm-up call and capture,
  ``mono`` its end); ``compile.cache``: one kernel library of
  ``ops/cuda/_build.py``, ``"hit"`` (loaded from ``_build/``) or
  ``"miss"`` (built by nvcc);
* ``memstats``: ``torch.cuda.memory_stats`` of the process's card
  (``allocated_bytes.all.current`` and ``.peak``), once an epoch;
* ``cost.*``: the FLOP/byte ledger of ``telemetry/costmodel.py``
  (``source`` ``"dispatch"``: aten ops counted on the meta device; or
  ``"analytic"``, the hand table); ``cost.memory`` is a graph's measured
  first-call peak (``source`` ``"graph"``);
* ``kernel.select``: which implementation runs for an op (``impl``
  ``"cuda"`` or ``"plain"``), once per op and run.
"""

from __future__ import annotations

# kind -> frozenset of required fields (beyond the envelope: jsonlog
# records carry {"t"}, telemetry records {"rank", "t"}).
KINDS: dict[str, frozenset] = {
    # -- the train/eval loop (utils/jsonlog.py, the primary's metrics.jsonl)
    "train": frozenset({"epoch", "batch", "loss", "top1", "topk", "lr"}),
    "eval": frozenset({"epoch", "loss", "top1", "topk", "samples"}),
    "epoch": frozenset({"epoch", "acc1", "best_acc1"}),
    "timeline": frozenset({"v", "phase", "epoch", "batch", "n"}),
    # -- serving --------------------------------------------------------------
    "serve": frozenset(
        {"requests", "rejected", "batches", "throughput_rps", "p50_ms",
         "p90_ms", "p99_ms", "batch_occupancy"}
    ),
    # one per quantized engine start: the weight repack's footprint
    "serve.quantized": frozenset(
        {"arch", "mode", "bytes_before", "bytes_after", "leaves"}
    ),
    # -- the serving fleet (serve/fleet/: router, pool, autoscaler) -----------
    "fleet.stats": frozenset(
        {"replicas", "routable", "requests", "rejected", "rerouted",
         "p50_ms", "p90_ms", "p99_ms"}
    ),
    "fleet.replica": frozenset(
        {"replica", "routable", "inflight", "queue_depth", "ewma_ms",
         "requests"}
    ),
    "fleet.scale": frozenset({"action", "reason", "n_before", "n_after"}),
    "fleet.model_route": frozenset(
        {"model", "requests", "rejected", "degraded_in", "degraded_out",
         "p99_ms"}
    ),
    # one row a length class on a length-aware fleet (the router's split at
    # SERVE.LONG_PROMPT_THRESHOLD prompt tokens)
    "fleet.length_class": frozenset(
        {"length_class", "threshold", "requests", "rejected", "p99_ms"}
    ),
    # -- resilience (a rank's own: mirrored to its sink) ----------------------
    "stall": frozenset({"age_s", "count"}),
    "data_error": frozenset({"index", "attempts", "error"}),
    "nonfinite": frozenset({"epoch", "batch", "policy"}),
    # -- the telemetry layer (per-rank sink, telemetry/spans.py) --------------
    "clock": frozenset({"unix", "mono"}),
    "span": frozenset({"v", "name", "t0", "dur", "track"}),
    "registry": frozenset({"v", "counters", "gauges", "histograms"}),
    "compile": frozenset({"event", "dur_s", "mono"}),
    "memstats": frozenset({"device", "bytes_in_use", "peak_bytes_in_use"}),
    # one per background checkpoint commit: on-path snapshot, off-path commit
    "ckpt.async": frozenset({"ckpt", "snapshot_s", "commit_s", "ok"}),
    # one per process per many-process background save: its wait at the
    # cross-host commit barrier (asyncplane/committer.multihost_commit)
    "ckpt.barrier": frozenset({"ckpt", "host", "hosts", "wait_s"}),
    # one per process per sharded background save: its own shard write
    "ckpt.shard": frozenset({"ckpt", "host", "hosts", "shards", "bytes", "write_s"}),
    # once per distinct ZeRO schedule (parallel/zero.log_schedule): leaves
    # resting split over data, entry gathers hoisted, the ZERO.* knobs
    "zero.schedule": frozenset(
        {"stage", "leaves", "sharded", "hoisted", "overlap", "gather_ahead"}
    ),
    "compile.cache": frozenset({"event", "hits", "misses"}),
    # -- the FLOP/byte ledger (telemetry/costmodel.py) ------------------------
    "cost.step": frozenset(
        {"v", "label", "phase", "flops", "images", "steps_per_call",
         "peak_flops", "source"}
    ),
    "cost.memory": frozenset(
        {"v", "label", "phase", "total_bytes", "capacity_bytes",
         "headroom_pct", "source"}
    ),
    "cost.roofline": frozenset(
        {"v", "label", "phase", "arithmetic_intensity", "ridge_intensity",
         "bound", "source"}
    ),
    # -- the LM plane (lm/generate.py, lm/service.py) -------------------------
    "lm.tokens": frozenset(
        {"prompt_tokens", "new_tokens", "decode_steps", "elapsed_s"}
    ),
    "gen.admit": frozenset({"slot", "prompt_tokens", "request"}),
    "gen.prefill": frozenset({"tokens", "tile", "ms"}),
    "gen.chunk_prefill": frozenset(
        {"tokens", "chunk", "chunks", "tile", "ms"}
    ),
    "gen.decode": frozenset({"active", "tile_b", "tile_c", "ms"}),
    "gen.retire": frozenset({"slot", "new_tokens", "reason", "request"}),
    "gen.speculate": frozenset(
        {"k", "active", "proposed", "accepted", "bonus", "ms"}
    ),
    "gen.sample": frozenset(
        {"request", "temperature", "top_k", "top_p", "seed"}
    ),
    # -- the kernel tier (ops/cuda/__init__.py) -------------------------------
    "kernel.select": frozenset({"op", "impl", "requested"}),
    # -- request traces (telemetry/tracectx.py) -------------------------------
    "trace.span": frozenset({"v", "trace", "span", "parent", "name",
                             "t0", "dur"}),
    # one an exemplar trace id a fired p99-breach or backpressure alert names
    "trace.exemplar": frozenset({"v", "rule", "trace", "latency_ms"}),
    # -- the live monitor (telemetry/live.py; MONITOR.jsonl) ------------------
    "monitor.snapshot": frozenset(
        {"v", "window_s", "steps", "straggler_skew", "events", "compiles",
         "totals"}
    ),
    "alert": frozenset({"rule", "value", "threshold", "message"}),
    # -- the soak referee (soak.py) -------------------------------------------
    "soak.interval": frozenset(
        {"interval", "name", "expected_alerts", "raised_alerts", "ok"}
    ),
    "soak.verdict": frozenset(
        {"ok", "intervals", "alerts_exact", "control_clean",
         "gates_evaluated"}
    ),
    # -- serving campaigns (serve/campaign/) ----------------------------------
    "campaign.phase": frozenset(
        {"campaign", "phase", "expected_alerts", "raised_alerts", "ok"}
    ),
    "campaign.verdict": frozenset(
        {"campaign", "phases", "alerts_exact", "control_clean", "ok"}
    ),
}


class SchemaError(ValueError):
    """A record (or call site) violates the declared kind schema."""


def check_fields(kind: str, fields) -> None:
    """Raise SchemaError on an undeclared kind or a missing required
    field; ``fields`` is any iterable of field names."""
    if kind not in KINDS:
        raise SchemaError(
            f"undeclared kind {kind!r}: declare it (with its required "
            "fields) in distribuuuu_tpu_torch/telemetry/schema.py"
        )
    missing = KINDS[kind] - set(fields)
    if missing:
        raise SchemaError(
            f"kind {kind!r} missing required fields {sorted(missing)} "
            "(declared in telemetry/schema.py)"
        )


def validate_record(rec: dict) -> None:
    """Check one emitted record (a parsed JSONL line)."""
    kind = rec.get("kind")
    if kind is None:
        raise SchemaError(f"record has no 'kind': {rec}")
    check_fields(kind, rec.keys())
