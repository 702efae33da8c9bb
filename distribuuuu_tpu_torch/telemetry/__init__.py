"""The port's telemetry layer (counterpart of distribuuuu_tpu/telemetry/):
a port run leaves the records a JAX run leaves, the same kinds, required
fields, span names and tracks, under the same files of ``OUT_DIR``.

    spans.py     the per-rank JSONL sink, span()/emit_span()/emit_event()
    registry.py  counters, gauges, histograms; one snapshot schema
    runtime.py   graph captures (kind="compile"), kernel-build cache
                 events, the card's memory once an epoch
    schema.py    the declared kinds and their required fields
    costmodel.py the FLOP/byte ledger counted on the meta device, in
                 place of XLA's cost analysis: cost.* records, MFU,
                 roofline, the graph's memory headroom
    export.py    N rank files + timeline records -> a Perfetto trace
    tracectx.py  request trace contexts and trace.span records

``utils/jsonlog.py`` is the primary's ``metrics.jsonl``. Readers:
``tools/run_report.py`` (unchanged: a report and ``--trace``), Perfetto.

On or off, telemetry trains the same bits and serves the same tokens
(``tests/test_torch_telemetry.py``). ``live.py`` (the monitor and soak
referee) is not ported.
"""

from distribuuuu_tpu_torch.telemetry.registry import (  # noqa: F401
    Registry,
    emit_snapshot,
    get_registry,
)
from distribuuuu_tpu_torch.telemetry.spans import (  # noqa: F401
    close_telemetry,
    emit_event,
    emit_span,
    enabled,
    setup_telemetry,
    span,
)


def setup_from_cfg(cfg, rank: int = 0) -> str | None:
    """What ``train_model``, ``test_model`` and ``serve_net`` call: open
    this rank's sink under the ``TELEMETRY`` node and install the capture
    hooks. Returns the sink's path, or None under ``TELEMETRY.ENABLED``
    False (the hooks are then off too). A sink that cannot be opened
    raises. A new sink counts the ledger's labels and records the kernel
    choices afresh, so each run's file holds its own."""
    import os

    from distribuuuu_tpu_torch.ops import cuda as kernel_tier
    from distribuuuu_tpu_torch.telemetry import costmodel, runtime

    if not cfg.TELEMETRY.ENABLED:
        close_telemetry()
        runtime.uninstall_compile_listener()
        return None
    tdir = cfg.TELEMETRY.DIR or os.path.join(cfg.OUT_DIR, "telemetry")
    path = setup_telemetry(tdir, rank=rank)
    if cfg.TELEMETRY.COMPILE_EVENTS:
        runtime.install_compile_listener()
    else:
        runtime.uninstall_compile_listener()
    costmodel.reset()
    kernel_tier.reset_selected()
    return path
