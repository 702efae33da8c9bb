"""The structured metrics sink: one JSON object a line in
``{OUT_DIR}/metrics.jsonl`` (counterpart of distribuuuu_tpu/utils/jsonlog.py,
the same records).

Every train print window, eval summary and epoch boundary lands here as a
record, beside the text log. A module singleton: ``setup_metrics_log`` in
``train_model``/``test_model``/``serve_net``, then :func:`metrics_log` from
anywhere; a no-op until set up, and on every process but the primary.
"""

from __future__ import annotations

import json
import os
import threading
import time

from distribuuuu_tpu_torch.telemetry import spans

_sink = {"f": None}
_lock = threading.Lock()


def setup_metrics_log(out_dir: str, primary: bool = True) -> None:
    """Open (append) the sink on the primary process; close any previous."""
    close_metrics_log()
    if not primary:
        return
    os.makedirs(out_dir, exist_ok=True)
    _sink["f"] = open(os.path.join(out_dir, "metrics.jsonl"), "a", buffering=1)


# Stage-boundary stamps of one kind="timeline" record, in pipeline order,
# all time.perf_counter() seconds of one process (differenced, never read
# as dates):
#   submit        the batch's assembly submitted to the loader's pool
#   dec0 / dec1   decode and augment (the pool's thread)
#   asm1          the host batch assembled
#   get0 / get1   the consumer waiting for the host batch
#   put0 / put1   issuing the host-to-device copies
#   step0 / step1 the step's call (a graph replay on the card: its dispatch)
# The consumer's intervals (get, put, step) are disjoint, so their sums
# and the residual partition the epoch's wall (tools/overlap_report.py).
TIMELINE_STAGES = (
    "submit", "dec0", "dec1", "asm1",
    "get0", "get1", "put0", "put1", "step0", "step1",
)
TIMELINE_SCHEMA = 1


def timeline_log(phase: str, epoch: int, batch: int, n: int, **stamps) -> None:
    """One batch's timeline record: ``phase`` ("train"/"eval"), 1-based
    ``epoch``, 0-based ``batch``, ``n`` images, and the TIMELINE_STAGES
    stamps present in ``stamps``. A no-op without the sink."""
    if _sink["f"] is None:
        return
    rec = {k: round(float(stamps[k]), 6) for k in TIMELINE_STAGES if k in stamps}
    metrics_log("timeline", v=TIMELINE_SCHEMA, phase=phase, epoch=epoch, batch=batch, n=n,
                **rec)


def metrics_log(kind: str, **fields) -> None:
    """Append one record ``{"t", "kind", **fields}``; a no-op without the
    sink. Every record is also mirrored to the per-rank telemetry sink
    when one is open, before the primary gate, so a rank's own kinds
    (stall, data_error, nonfinite) survive on ranks > 0; ``timeline``
    records stay here only (the exporter reads them from this file)."""
    spans.mirror_event(kind, fields)
    if _sink["f"] is None:
        return
    rec = {"t": round(time.time(), 3), "kind": kind}
    rec.update(fields)
    line = json.dumps(rec) + "\n"
    with _lock:
        if _sink["f"] is not None:
            _sink["f"].write(line)


def close_metrics_log() -> None:
    with _lock:
        if _sink["f"] is not None:
            _sink["f"].close()
            _sink["f"] = None
