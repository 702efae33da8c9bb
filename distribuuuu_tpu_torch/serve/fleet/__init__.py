"""Serving fleet (counterpart of distribuuuu_tpu/serve/fleet/): a
shared-nothing replica pool behind a router process.

* each replica IS the single-engine ``serve_net`` (dynamic micro-batching
  over graphed bucket shapes, or the LM's continuous batching) in its own
  process, with its own CUDA context (several share one card);
* draining restarts chain through the SIGTERM drain protocol, so deploys
  and scale-downs lose zero requests;
* the least-loaded policy and the autoscaler read the Registry
  instruments the replicas report through their stats control frame.

    router.py     least-loaded dispatch, idempotent retry, verbatim
                  backpressure passthrough, streaming generate relay,
                  length classes, fleet-wide latency telemetry
    pool.py       replica lifecycle: spawn, warm-up-gated routability,
                  health probes, draining restarts, target maintenance;
                  FleetService composes router+pool+autoscaler
    autoscale.py  p99-target/queue-watermark policy loop with hysteresis

Entry point: ``python -m distribuuuu_tpu_torch.serve_net --fleet N``.
"""

from distribuuuu_tpu_torch.serve.fleet.autoscale import (  # noqa: F401
    AutoscalePolicy,
    Autoscaler,
    Observation,
)
from distribuuuu_tpu_torch.serve.fleet.pool import (  # noqa: F401
    FleetService,
    PoolManager,
    free_port,
    probe_stats,
    spawn_serve_net,
    warmed_up,
)
from distribuuuu_tpu_torch.serve.fleet.router import (  # noqa: F401
    LoadSnapshot,
    Replica,
    Router,
    load_score,
    pick_replica,
)
