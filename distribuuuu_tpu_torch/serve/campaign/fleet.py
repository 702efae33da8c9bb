"""Multi-model fleet: one router, N model variants, per-model pools
(counterpart of distribuuuu_tpu/serve/campaign/fleet.py).

A ``MultiModelFleet`` composes the single-model building blocks of
``serve/fleet/``:

* ONE ``Router`` fronts the whole fleet. Replicas are tagged with the
  model id they serve (``Router.add_replica(..., model=...)``), model ids
  are registered with their SLO class (``Router.register_model``), and
  the model-envelope frames (``protocol.model_envelope``) steer each
  request to its model's replicas, with overflow to the configured cheap
  model when the expensive model saturates (the degrade-under-pressure
  path the campaign referee scores).
* One ``PoolManager`` PER MODEL owns that model's replica lifecycle. Each
  pool spawns ``python -m distribuuuu_tpu_torch.serve_net`` replicas from
  its own dumped config (its own arch, ``SERVE.QUANTIZE`` mode, bucket
  graphs and telemetry subdir), so every replica stays shared-nothing and
  the serving protocol is untouched end to end. On one card every
  replica is its own CUDA context on ``SERVE.DEVICE``.

Weights come from ``MODEL.WEIGHTS`` (or seeded init) at spawn, and
``rolling_update`` pages new weights in mid-traffic by rewriting the
model's dumped config and draining-restarting its replicas one at a time:
zero failed requests by the pool's drain ordering, while OTHER models'
traffic never reroutes.
"""

from __future__ import annotations

import os
import threading

from distribuuuu_tpu_torch.serve.fleet.pool import PoolManager, spawn_serve_net
from distribuuuu_tpu_torch.serve.fleet.router import Router, freeze_heap, thaw_heap
from distribuuuu_tpu_torch.utils.logger import get_logger

# per-model override keys a fleet spec may set on top of the base cfg
_SPEC_KEYS = {"name", "arch", "replicas", "quantize", "overrides",
              "slo_class", "p99_slo_ms", "overflow_to"}


class MultiModelFleet:
    """N model variants behind one router.

    ``model_specs`` rows::

        {"name": "resnet50", "arch": "resnet50", "replicas": 1,
         "quantize": "", "overrides": {...merge_from_list pairs...},
         "slo_class": "premium", "p99_slo_ms": 300.0,
         "overflow_to": "resnet18"}

    ``name`` is the routing id (what request envelopes carry); ``arch``
    defaults to it. ``overrides`` is a flat {cfg_key: value} dict merged
    into that model's replica config. The fleet keeps a copy of ``cfg``,
    so a later change of the global config (another fleet's) leaves this
    one's rolling updates alone.
    """

    def __init__(self, cfg, model_specs, *, out_dir: str | None = None):
        cfg = cfg.clone()
        fl = cfg.SERVE.FLEET
        self.cfg = cfg
        self.out_dir = out_dir or cfg.OUT_DIR
        self.router = Router(
            request_timeout_s=fl.REQUEST_TIMEOUT_S,
            long_prompt_threshold=cfg.SERVE.LONG_PROMPT_THRESHOLD,
            short_p99_slo_ms=cfg.SERVE.SHORT_P99_SLO_MS,
            long_p99_slo_ms=cfg.SERVE.LONG_P99_SLO_MS,
        )
        self.pools: dict[str, PoolManager] = {}
        self._targets: dict[str, int] = {}
        self._cfg_paths: dict[str, str] = {}
        self.logger = get_logger()
        self.gc_full_ms = None  # the full collection before the heap froze
        self._frozen = False
        for spec in model_specs:
            bad = sorted(set(spec) - _SPEC_KEYS)
            if bad:
                raise ValueError(f"unknown fleet model-spec keys: {bad}")
            name = spec["name"]
            if name in self.pools:
                raise ValueError(f"duplicate fleet model id {name!r}")
            self.router.register_model(
                name,
                slo_class=spec.get("slo_class", "standard"),
                p99_slo_ms=spec.get("p99_slo_ms"),
                overflow_to=spec.get("overflow_to"),
            )
            model_dir = os.path.join(self.out_dir, f"model_{name}")
            cfg_path = self._dump_model_cfg(model_dir, spec)
            self._cfg_paths[name] = cfg_path
            self.pools[name] = PoolManager(
                self.router,
                spawn_serve_net(
                    cfg_path, host=cfg.SERVE.HOST,
                    out_dir=os.path.join(model_dir, "fleet"),
                ),
                model=name,
                host=cfg.SERVE.HOST,
                min_replicas=0,
                max_replicas=fl.MAX_REPLICAS,
                warmup_timeout_s=fl.WARMUP_TIMEOUT_S,
                health_period_s=fl.HEALTH_PERIOD_S,
                health_fails=fl.HEALTH_FAILS,
            )
            self._targets[name] = int(spec.get("replicas", 1))

    def _dump_model_cfg(self, model_dir: str, spec: dict) -> str:
        """Materialize this model's replica config: base cfg + arch +
        quantize mode + overrides, each model in its own telemetry subdir
        so replica sink files never collide across models."""
        os.makedirs(model_dir, exist_ok=True)
        mcfg = self.cfg.clone()
        mcfg.defrost()
        mcfg.MODEL.ARCH = spec.get("arch") or spec["name"]
        mcfg.SERVE.QUANTIZE = spec.get("quantize", "")
        mcfg.OUT_DIR = model_dir
        flat = []
        for key, val in (spec.get("overrides") or {}).items():
            flat += [key, val]
        if flat:
            mcfg.merge_from_list(flat)
        mcfg.freeze()
        cfg_path = os.path.join(model_dir, "replica_cfg.yaml")
        with open(cfg_path, "w") as f:
            f.write(mcfg.dump())
        return cfg_path

    def replica_logs(self) -> dict[str, list[str]]:
        """{model: [replica log paths]} (each names the replica's kernel
        launches after warm-up and at the drain)."""
        out = {}
        for name in self.pools:
            d = os.path.join(self.out_dir, f"model_{name}", "fleet")
            out[name] = sorted(
                os.path.join(d, f) for f in os.listdir(d) if f.endswith(".log")
            ) if os.path.isdir(d) else []
        return out

    # -- lifecycle ---------------------------------------------------------
    def start(self, *, wait: bool = True) -> "MultiModelFleet":
        """Spawn every model's replicas concurrently (warm-up gated per
        replica as always); with ``wait``, block until the whole fleet is
        routable (``wait_routable``), then start per-pool supervision."""
        for name, pool in self.pools.items():
            pool.set_target(self._targets[name])
            pool._spawn_toward_target()
        if wait:
            self.wait_routable()
        return self

    def wait_routable(self) -> "MultiModelFleet":
        """Join the warm-ups ``start(wait=False)`` began (each pool waits
        on its own model's replicas only), start supervision, and freeze
        this process's heap while the fleet serves (``router.freeze_heap``;
        ``gc_full_ms`` is what its full collection took)."""
        for name, pool in self.pools.items():
            pool._wait_routable(self._targets[name])
        for pool in self.pools.values():
            pool.start_supervisor()
        if not self._frozen:
            self.gc_full_ms, self._frozen = freeze_heap(), True
        return self

    def rolling_update(self, model: str, overrides: dict,
                       *, wait: bool = True) -> dict:
        """Page new weights/config into ONE model mid-traffic: rewrite
        that model's dumped replica config with ``overrides``
        ({cfg_key: value}), then draining-restart its replicas one at a
        time. Other models' pools are untouched."""
        pool = self.pools[model]
        cfg_path = self._cfg_paths[model]
        mcfg = self.cfg.clone()
        mcfg.defrost()
        mcfg.merge_from_file(cfg_path)
        flat = []
        for key, val in overrides.items():
            flat += [key, val]
        if flat:
            mcfg.merge_from_list(flat)
        mcfg.freeze()
        with open(cfg_path, "w") as f:
            f.write(mcfg.dump())
        rids = [r.id for r in self.router.replicas() if r.model == model]
        self.logger.info(
            "fleet: rolling update of %s over replicas %s (%s)",
            model, rids, overrides,
        )
        for rid in rids:
            pool.restart_replica(rid, wait=wait)
        return {"model": model, "replicas": rids, "overrides": overrides}

    def serve(self, listener, should_stop, poll_s: float = 0.25) -> None:
        self.router.serve(
            listener, should_stop, poll_s=poll_s,
            emit_interval_s=self.cfg.SERVE.FLEET.EMIT_INTERVAL_S,
        )

    def shutdown(self) -> None:
        threads = [
            threading.Thread(target=p.shutdown, daemon=True)
            for p in self.pools.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        self.router.emit_telemetry()
        if self._frozen:
            self._frozen = False
            thaw_heap()
