"""Online inference serving of the port: ``engine.py`` (dynamic
micro-batching over warmed bucket shapes, double-buffered dispatch,
per-request futures), ``admission.py`` (bounded-queue backpressure +
SIGTERM drain), ``metrics.py`` (latency / occupancy / throughput),
``protocol.py`` (length-prefixed socket frontend + batch mode).
Entry point: ``python -m distribuuuu_tpu_torch.serve_net``.
"""

from distribuuuu_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    EngineClosedError,
    QueueFullError,
    drain_requested,
    install_drain,
)
from distribuuuu_tpu_torch.serve.engine import (  # noqa: F401
    COMPILE_EVENTS,
    Engine,
    default_buckets,
    engine_from_cfg,
)
from distribuuuu_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
