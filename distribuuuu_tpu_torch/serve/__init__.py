"""Online inference serving of the port: ``engine.py`` (dynamic
micro-batching over warmed bucket shapes, double-buffered dispatch,
per-request futures), ``admission.py`` (bounded-queue backpressure +
SIGTERM drain), ``metrics.py`` (latency / occupancy / throughput),
``protocol.py`` (length-prefixed socket frontend + batch mode),
``fleet/`` (router, replica pool, autoscaler), ``campaign/``
(multi-model fleets, seeded traffic campaigns, the alert referee).
Entry points: ``python -m distribuuuu_tpu_torch.serve_net`` and
``python -m distribuuuu_tpu_torch.serve_campaign``.
"""

from distribuuuu_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    EngineClosedError,
    LongQueueFullError,
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
