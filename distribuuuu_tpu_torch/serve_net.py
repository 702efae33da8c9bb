"""Serve a classification model or an LM online on the card (the port's
twin of the top-level ``serve_net.py``).

Builds the configured arch (weights from ``MODEL.WEIGHTS``, a torch
``.pth``, or made from ``RNG_SEED``). An image arch gets the val transform
and the dynamic micro-batching engine; a ``gpt_*`` arch gets the
continuous-batching generation engine (``lm/service.py``), driven by
streaming ``op="generate"`` control frames. Both listen on a
length-prefixed socket; SIGTERM drains gracefully. Runs on
``cuda:{SERVE.DEVICE}`` unless ``DEVICE.PLATFORM cpu``. Telemetry lands
under ``OUT_DIR``: ``telemetry/rank00000.jsonl`` (the warm-up's captures,
the buckets' ledger, ``gen.*``/``lm.tokens`` and traced requests'
``trace.span``) and ``metrics.jsonl`` (``serve`` snapshots). The log
names the kernel launches after warm-up and at the drain.

``--fleet N`` runs an N-replica serving fleet instead of one engine
(``serve/fleet/``): this process becomes the router on
``SERVE.HOST:PORT`` and spawns N replicas, each a plain ``serve_net`` on
an ephemeral port with the merged config (every override: MODEL.WEIGHTS,
SERVE.QUANTIZE, DEVICE.*) and the telemetry rank 1.. from
``DTPU_REPLICA_RANK`` (the router is rank 0); warm-up gated,
health-checked, replaced when they die, and autoscaled against
``SERVE.FLEET``. On one card every replica is a process with its own CUDA
context on ``cuda:0``. SIGTERM drains the whole fleet.

Usage:
    python -m distribuuuu_tpu_torch.serve_net --cfg config/resnet50.yaml \\
        [MODEL.WEIGHTS path/to/resnet50.pth] [KEY VALUE ...]
    python -m distribuuuu_tpu_torch.serve_net --cfg config/gpt_nano.yaml
    DISTRIBUUUU_GROUP_CONV=pallas python -m distribuuuu_tpu_torch.serve_net \
        --cfg config/regnety_160.yaml   # stage 3's grouped convs on the kernel

    # one-shot batch mode: val-transformed .npy in, logits .npy out
    python -m distribuuuu_tpu_torch.serve_net --cfg config/resnet50.yaml \\
        --batch-input imgs.npy --batch-output logits.npy

    # a 2-replica int8 fleet behind one router port, weights from a JAX
    # orbax checkpoint (--fleet before the KEY VALUE overrides)
    python -m distribuuuu_tpu_torch.serve_net --cfg config/resnet50.yaml --fleet 2 \\
        MODEL.WEIGHTS path/to/orbax/best SERVE.QUANTIZE int8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import distribuuuu_tpu_torch.config as config
from distribuuuu_tpu_torch.config import cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve a classification model or an LM.")
    parser.add_argument("--cfg", dest="cfg_file", required=True, type=str,
                        help="Config file location")
    parser.add_argument("--fleet", type=int, default=0, metavar="N",
                        help="run an N-replica fleet (router + pool + autoscaler) instead "
                             "of a single engine; 0 = single-replica mode")
    parser.add_argument("--batch-input", default=None,
                        help="one-shot batch mode: .npy of val-transformed images "
                             "('-' = stdin) instead of the socket server")
    parser.add_argument("--batch-output", default="-",
                        help="batch-mode logits .npy destination ('-' = stdout)")
    parser.add_argument("opts", help="See distribuuuu_tpu_torch/config.py for all options",
                        default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.fleet and args.batch_input is not None:
        raise SystemExit("--batch-input is one engine's one-shot mode; a fleet serves "
                         "its router port")
    config.merge_from_file(args.cfg_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    if args.fleet:
        return run_fleet(args.fleet)
    lm = cfg.MODEL.ARCH.startswith("gpt")
    if lm and args.batch_input is not None:
        raise SystemExit(
            "--batch-input is the image engine's one-shot mode; "
            "drive a gpt_* replica with generate ctrl frames "
            "(lm/service.generate_request) instead"
        )

    from distribuuuu_tpu_torch import telemetry
    from distribuuuu_tpu_torch.utils.jsonlog import close_metrics_log, setup_metrics_log
    from distribuuuu_tpu_torch.utils.logger import get_logger, setup_logger

    setup_logger()
    # a standalone replica is rank 0; a fleet replica takes its rank from
    # the pool, so N replicas sharing OUT_DIR write N sinks
    telemetry.setup_from_cfg(cfg, rank=int(os.environ.get("DTPU_REPLICA_RANK", "0")))
    setup_metrics_log(cfg.OUT_DIR)
    try:
        _serve(args, lm, get_logger())
    finally:
        telemetry.close_telemetry()
        close_metrics_log()


def _launches() -> str:
    """The process's kernel launches so far (``ops/cuda``), as JSON."""
    from distribuuuu_tpu_torch.ops import cuda as kernel_tier

    return json.dumps(kernel_tier.launch_counts(), sort_keys=True)


def _serve(args, lm: bool, logger) -> None:
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.serve import admission, engine_from_cfg, protocol

    if lm:
        from distribuuuu_tpu_torch.lm import service as lm_service

        engine = lm_service.engine_from_cfg()
        logger.info(
            "generating with %s on %s: %d tiles warmed (decode tiles %s), %d slots, "
            "prompt<=%d, max_new=%d",
            cfg.MODEL.ARCH, engine.device, engine.n_compiles, engine.stats()["buckets"],
            engine.n_slots, engine.prompt_len, engine.max_new,
        )
    else:
        engine = engine_from_cfg()
        logger.info(
            "serving %s on %s: buckets %s warmed (%d shapes), max_wait %.1f ms, "
            "queue bound %d",
            cfg.MODEL.ARCH, engine.device, engine.buckets, engine.n_compiles,
            cfg.SERVE.MAX_WAIT_MS, cfg.SERVE.MAX_QUEUE,
        )
    logger.info("kernel launches after warm-up: %s", _launches())
    engine.start()

    if args.batch_input is not None:
        n = protocol.run_batch(engine, args.batch_input, args.batch_output)
        engine.drain()
        logger.info("batch mode: served %d requests", n)
        return

    admission.install_drain()
    listener = protocol.open_listener(cfg.SERVE.HOST, cfg.SERVE.PORT)
    host, port = listener.getsockname()[:2]
    logger.info("listening on %s:%d (SIGTERM drains gracefully)", host, port)
    try:
        protocol.serve_forever(engine, listener, should_stop=admission.drain_requested,
                               topk=trainer.effective_topk())
    except KeyboardInterrupt:
        listener.close()
        engine.drain()
    logger.info("kernel launches at drain: %s", _launches())
    logger.info("drained; exiting")


def run_fleet(n: int) -> None:
    """``--fleet N``: this process is the router (telemetry rank 0);
    replicas are child ``serve_net`` processes spawned from a dump of the
    merged config. SIGTERM drains the fleet end to end."""
    from distribuuuu_tpu_torch import telemetry
    from distribuuuu_tpu_torch.serve import admission, protocol
    from distribuuuu_tpu_torch.serve.fleet import FleetService
    from distribuuuu_tpu_torch.utils.jsonlog import close_metrics_log, setup_metrics_log
    from distribuuuu_tpu_torch.utils.logger import get_logger, setup_logger

    setup_logger()
    logger = get_logger()
    telemetry.setup_from_cfg(cfg, rank=0)  # replicas take ranks 1..N
    setup_metrics_log(cfg.OUT_DIR)
    try:
        fleet_dir = os.path.join(cfg.OUT_DIR, "fleet")
        os.makedirs(fleet_dir, exist_ok=True)
        cfg_path = os.path.join(fleet_dir, "replica_cfg.yaml")
        with open(cfg_path, "w") as f:
            f.write(cfg.dump())
        svc = FleetService(cfg, n, cfg_path=cfg_path)
        logger.info("fleet: spawning %d replica(s) of %s (budget %d..%d, autoscale %s)",
                    n, cfg.MODEL.ARCH, cfg.SERVE.FLEET.MIN_REPLICAS,
                    cfg.SERVE.FLEET.MAX_REPLICAS, cfg.SERVE.FLEET.AUTOSCALE)
        svc.start(wait=True)
        routable = svc.router.n_routable()
        if not routable:
            svc.shutdown()
            raise RuntimeError(f"fleet: no replica survived warm-up — see {fleet_dir}/replica*.log")
        admission.install_drain()  # SIGTERM → drain the whole fleet
        listener = protocol.open_listener(cfg.SERVE.HOST, cfg.SERVE.PORT)
        host, port = listener.getsockname()[:2]
        logger.info("fleet: router listening on %s:%d over %d routable replica(s) "
                    "(SIGTERM drains gracefully)", host, port, routable)
        try:
            svc.serve(listener, should_stop=admission.drain_requested)
        except KeyboardInterrupt:
            listener.close()
        svc.shutdown()
        logger.info("fleet drained; exiting")
    finally:
        telemetry.close_telemetry()
        close_metrics_log()


if __name__ == "__main__":
    main()
