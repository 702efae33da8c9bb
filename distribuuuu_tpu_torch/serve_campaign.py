"""Run traffic campaigns against a real multi-model fleet and write the
scored verdicts (the port's counterpart of tools/serve_campaign.py, with
its flags):

    # every shipped campaign (config/campaigns/*.yaml), the quantized
    # referee and the (model, dtype) latency frontier, on the card:
    python -m distribuuuu_tpu_torch.serve_campaign --out SERVE_CAMPAIGN.json

    # one campaign on the CPU at toy size:
    python -m distribuuuu_tpu_torch.serve_campaign \\
        --campaign config/campaigns/flash_crowd.yaml --no-frontier \\
        --no-quantized DEVICE.PLATFORM cpu

Trailing ``KEY VALUE`` pairs override the serving config of every
campaign, as in the port's other entry points; without
``DEVICE.PLATFORM cpu`` the replicas and the referees run on the card
(``cuda:{SERVE.DEVICE}``). Without ``--out`` the verdict file lands in
the work directory as ``SERVE_CAMPAIGN_r{round}.json``.

Per campaign YAML: build the fleet topology the campaign declares
(``serve/campaign/fleet.MultiModelFleet``: real ``serve_net`` replica
processes, per-model pools, one router), replay the seeded schedule open
loop (``serve/campaign/runner.py``), score every phase with the
alert-rule engine (raised == expected EXACTLY, control phases silent),
and record the determinism pin (the schedule built twice must hash
identically).

The quantized section is the accuracy referee (``serve/quantize.py``
``quantized_delta``): per (model, mode) the logits must stay within
TOLERANCE of f32. The frontier section measures the latency/throughput
cost of each (model, dtype) variant through the real engine (in process,
the graphed bucket path).

The default rates of the shipped YAMLs were written for replicas that
serve a few tens of requests a second (the JAX package's one-core CPU
toy); a faster fleet needs them scaled, which is the caller's business
(``chip_smoke.py`` derives a card spec).
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# replica counts per campaign model (the YAML declares traffic + SLO;
# topology is the harness's concern — keep it one honest table)
TOPOLOGY = {
    "rolling_update": {"resnet18": 2},  # >=2: one replica stays routable
    "degrade_under_pressure": {"resnet50": 1, "resnet18": 1},
    "lm_decode": {"gpt_nano": 1},  # one replica: the burst MUST overflow it
    "long_context": {"gpt_nano": 1},  # one replica: longs contend for ONE
    # long-class admission slot while shorts keep flowing
}

IM_SIZE = 16
NUM_CLASSES = 4
FRONTIER_ARCHS = ("resnet18", "resnet50")
FRONTIER_MODES = ("", "bf16", "int8")


def serve_knobs(cfg) -> None:
    """The campaign serving knobs: singles, no batch amplification, so a
    replica serves ~1/service_time rps and campaign rates mean what they
    say; a 16-deep admission queue puts ~16 service times of wait between
    "saturated" and "rejecting"."""
    cfg.SERVE.MAX_BATCH = 1
    cfg.SERVE.MAX_WAIT_MS = 0.0
    cfg.SERVE.MAX_QUEUE = 16
    cfg.SERVE.FLEET.AUTOSCALE = False  # campaigns pin their topology
    cfg.SERVE.FLEET.MIN_REPLICAS = 0
    cfg.SERVE.FLEET.HEALTH_PERIOD_S = 0.5


def lm_knobs(cfg) -> None:
    """The LM campaign's queue, tiles and budgets: tiny tiles and ~4
    stream service times of queue between "saturated" and "rejecting",
    so a flash burst of generate streams bounces while admitted streams
    keep decoding."""
    cfg.LM.SEQ_LEN = 32
    cfg.GENERATE.PROMPT_LEN = 8
    cfg.GENERATE.MAX_NEW_TOKENS = 10
    cfg.GENERATE.BATCH_TILES = [2]
    cfg.GENERATE.CACHE_TILES = [32]
    cfg.SERVE.MAX_QUEUE = 4
    cfg.SERVE.FLEET.AUTOSCALE = False
    cfg.SERVE.FLEET.MIN_REPLICAS = 0
    cfg.SERVE.FLEET.HEALTH_PERIOD_S = 0.5


def base_cfg(work: str, cfg_file: str | None = None, opts=()):
    """The campaign serve config. Without ``cfg_file``: the toy recipe
    (resnet18, 4 classes, 16², f32, float payloads, seeded weights); with
    one: that model at its own width and size. Then ``serve_knobs`` and
    ``opts``."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    if cfg_file:
        config.merge_from_file(cfg_file)
    else:
        cfg.MODEL.ARCH = "resnet18"
        cfg.MODEL.NUM_CLASSES = NUM_CLASSES
        cfg.MODEL.BN_GROUP = 8
        cfg.DEVICE.COMPUTE_DTYPE = "float32"
        cfg.TRAIN.IM_SIZE = IM_SIZE
        cfg.TEST.IM_SIZE = IM_SIZE
        cfg.DATA.DEVICE_NORMALIZE = False  # float payloads, no PIL
    cfg.RNG_SEED = 0
    cfg.OUT_DIR = work
    serve_knobs(cfg)
    cfg.merge_from_list(list(opts))
    return cfg


def lm_base_cfg(work: str, cfg_file: str | None = None, opts=()):
    """The LM campaign serve config: gpt_nano replicas (seeded init,
    greedy decode), f32 unless ``cfg_file`` says otherwise, with
    ``lm_knobs``, then ``opts``."""
    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg

    config.reset_cfg()
    if cfg_file:
        config.merge_from_file(cfg_file)
    else:
        cfg.MODEL.ARCH = "gpt_nano"
        cfg.MODEL.NUM_CLASSES = 320  # the byte tokenizer's vocab
        cfg.DEVICE.COMPUTE_DTYPE = "float32"
    cfg.RNG_SEED = 0
    cfg.OUT_DIR = work
    lm_knobs(cfg)
    cfg.merge_from_list(list(opts))
    return cfg


def long_context_cfg(work: str, cfg_file: str | None = None, opts=()):
    """The long-context campaign serve config: lm_base_cfg plus chunked
    prefill into a wider paged cache, the long-class admission
    reservation (1 of the 4 queue slots), and a short-class p99 SLO
    target so the slo-breach rule referees short-prompt latency against
    long-prompt interference (the router's ``length:short`` row)."""
    cfg = lm_base_cfg(work, cfg_file)
    cfg.LM.SEQ_LEN = 64
    cfg.GENERATE.MAX_NEW_TOKENS = 8
    cfg.GENERATE.CACHE_TILES = [64]
    cfg.GENERATE.CHUNK_PREFILL = 8
    cfg.SERVE.LONG_PROMPT_THRESHOLD = 16
    cfg.SERVE.LONG_MAX_QUEUE = 1
    cfg.SERVE.SHORT_P99_SLO_MS = 10000.0
    cfg.merge_from_list(list(opts))
    return cfg


def payload_bank(n: int = 8, seed: int = 0, im_size: int = IM_SIZE) -> list:
    """Pre-transformed float32 ``(im, im, 3)`` npy payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        buf = io.BytesIO()
        np.save(
            buf,
            rng.standard_normal((im_size, im_size, 3)).astype(np.float32),
        )
        out.append(buf.getvalue())
    return out


def lm_payload_bank(n: int = 8, seed: int = 0) -> list:
    """Token-prompt generate ctrl frames (lm/service.py wire shape): the
    LM twin of ``payload_bank``. Ragged prompt lengths exercise the
    prefill tiles; the budgets keep one stream ~6 decode steps."""
    from distribuuuu_tpu_torch.serve import protocol

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, 9))
        out.append(protocol.ctrl_request(
            "generate",
            tokens=[int(t) for t in rng.integers(0, 256, plen)],
            max_new_tokens=6 + i % 4,
        ))
    return out


def lm_long_payload_bank(n: int = 12, seed: int = 0,
                         max_prompt: int = 48) -> list:
    """Heavy-tailed prompt-length mix for the long-context campaign:
    Pareto-drawn lengths (mostly short, a fat tail of chunked-prefill long
    prompts) clamped to the paged-cache admission bound. Seed 0 lands 4/12
    prompts at or past the 16-token long-class threshold."""
    from distribuuuu_tpu_torch.serve import protocol

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = min(max_prompt, 2 + int(rng.pareto(0.9) * 5))
        out.append(protocol.ctrl_request(
            "generate",
            tokens=[int(t) for t in rng.integers(0, 256, plen)],
            max_new_tokens=4 + i % 4,
        ))
    return out


def fleet_specs(spec) -> list:
    """Campaign models (name/SLO from the YAML) + harness topology."""
    topo = TOPOLOGY.get(spec.name, {})
    return [
        {
            "name": m["name"],
            "replicas": int(topo.get(m["name"], 1)),
            "slo_class": m["slo_class"],
            "p99_slo_ms": m["p99_slo_ms"],
            "overflow_to": m["overflow_to"],
        }
        for m in spec.models
    ]


def campaign_cfg(spec, work: str, opts=()):
    """The serve config a campaign's models take: an all-gpt model list
    makes it an LM campaign (generate ctrl frames through the router's
    streaming branch instead of image payloads through dispatch)."""
    is_lm = all(m["name"].startswith("gpt") for m in spec.models)
    if spec.name == "long_context":
        return long_context_cfg(work, opts=opts)
    return lm_base_cfg(work, opts=opts) if is_lm else base_cfg(work, opts=opts)


def campaign_payloads(spec, cfg) -> list:
    is_lm = all(m["name"].startswith("gpt") for m in spec.models)
    if spec.name == "long_context":
        return lm_long_payload_bank()
    return lm_payload_bank() if is_lm else payload_bank(
        im_size=int(cfg.TRAIN.IM_SIZE))


def cycler(payloads: list):
    """``payload_for(model)``: the bank in turn, thread-safe."""
    counter = {"i": 0}
    lock = threading.Lock()

    def payload_for(model: str) -> bytes:
        with lock:
            counter["i"] += 1
            return payloads[counter["i"] % len(payloads)]

    return payload_for


def run_campaign(path: str, work: str, log, *, opts=()) -> dict:
    from distribuuuu_tpu_torch.serve.campaign import dsl
    from distribuuuu_tpu_torch.serve.campaign.fleet import MultiModelFleet
    from distribuuuu_tpu_torch.serve.campaign.runner import CampaignRunner

    spec = dsl.load_campaign(path)
    # the determinism pin: the schedule is a pure function of (YAML, seed)
    h1 = dsl.schedule_hash(dsl.build_schedule(spec))
    h2 = dsl.schedule_hash(dsl.build_schedule(spec))

    cdir = os.path.join(work, spec.name)
    cfg = campaign_cfg(spec, cdir, opts)
    specs = fleet_specs(spec)
    log(f"campaign {spec.name}: fleet "
        f"{ {s['name']: s['replicas'] for s in specs} } warming up ...")
    fleet = MultiModelFleet(cfg, specs, out_dir=cdir)
    t0 = time.perf_counter()
    fleet.start(wait=True)
    log(f"campaign {spec.name}: fleet routable in "
        f"{time.perf_counter() - t0:.1f}s")
    try:
        runner = CampaignRunner(
            spec, fleet.router,
            payload_for=cycler(campaign_payloads(spec, cfg)), fleet=fleet,
            trace_sample=cfg.SERVE.TRACE_SAMPLE,
        )
        verdict = runner.run()
    finally:
        fleet.shutdown()
    verdict["yaml"] = os.path.relpath(os.path.abspath(path), ROOT)
    verdict["fleet"] = {s["name"]: s["replicas"] for s in specs}
    verdict["deterministic"] = (
        h1 == h2 == verdict["schedule_hash"]
    )
    verdict["ok"] = verdict["ok"] and verdict["deterministic"]
    log(f"campaign {spec.name}: ok={verdict['ok']} "
        f"(alerts_exact={verdict['alerts_exact']} "
        f"control_clean={verdict['control_clean']} "
        f"deterministic={verdict['deterministic']})")
    return verdict


def measure_frontier(work: str, log, n_lat: int = 80,
                     burst_s: float = 2.0, opts=()) -> list:
    """The (model, dtype) serving cost frontier through the REAL engine:
    per variant, sequential single-request p50/p99 (the bucket-1 graph)
    and a short closed-loop throughput probe (4 clients)."""
    from distribuuuu_tpu_torch.serve.engine import engine_from_cfg

    rows = []
    for arch in FRONTIER_ARCHS:
        for mode in FRONTIER_MODES:
            cfg = base_cfg(os.path.join(work, f"frontier_{arch}_{mode or 'f32'}"),
                           opts=opts)
            cfg.MODEL.ARCH = arch
            cfg.SERVE.QUANTIZE = mode
            im = int(cfg.TRAIN.IM_SIZE)
            rng = np.random.default_rng(0)
            img = rng.standard_normal((im, im, 3)).astype(np.float32)
            if cfg.DATA.DEVICE_NORMALIZE:
                img = rng.integers(0, 256, (im, im, 3), np.uint8)
            t0 = time.perf_counter()
            eng = engine_from_cfg().start()  # from_cfg returns it unstarted
            compile_s = time.perf_counter() - t0
            try:
                for _ in range(5):  # warm the bucket-1 path
                    eng.submit(img).result()
                lats = []
                for _ in range(n_lat):
                    t1 = time.perf_counter()
                    eng.submit(img).result()
                    lats.append((time.perf_counter() - t1) * 1e3)
                lats.sort()
                done = {"n": 0}
                stop_at = time.perf_counter() + burst_s

                def client():
                    while time.perf_counter() < stop_at:
                        eng.submit(img).result()
                        done["n"] += 1

                threads = [
                    threading.Thread(target=client, daemon=True)
                    for _ in range(4)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                qmeta = getattr(eng, "quantize_meta", None)
                row = {
                    "model": arch,
                    "dtype": mode or "f32",
                    "p50_ms": round(lats[len(lats) // 2], 2),
                    "p99_ms": round(lats[min(len(lats) - 1,
                                             int(len(lats) * 0.99))], 2),
                    "throughput_rps": round(done["n"] / burst_s, 1),
                    "compile_s": round(compile_s, 1),
                    "weight_bytes": (
                        int(qmeta["bytes_after"]) if qmeta else None
                    ),
                }
                rows.append(row)
                log(f"frontier {arch}/{mode or 'f32'}: "
                    f"p50 {row['p50_ms']}ms p99 {row['p99_ms']}ms "
                    f"{row['throughput_rps']} rps")
            finally:
                eng.drain()
    return rows


def quantized_report(log, opts=()) -> list:
    """The accuracy referee: per (model, mode), logits of the quantized
    weights against f32 within TOLERANCE (``serve/quantize.py``), on the
    device the config names."""
    import torch

    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.serve import quantize as qlib

    rng = np.random.default_rng(0)
    rows = []
    for arch in FRONTIER_ARCHS:
        cfg = base_cfg(tempfile.gettempdir(), opts=opts)
        cfg.MODEL.ARCH = arch
        im = int(cfg.TRAIN.IM_SIZE)
        device = trainer.device_from_cfg()
        model = trainer.build_model_from_cfg().to(device)
        images = torch.from_numpy(rng.standard_normal(
            (8, im, im, 3)
        ).astype(np.float32)).to(device)
        for mode in ("bf16", "int8"):
            row = qlib.quantized_delta(model, images, mode)
            row["model"] = arch
            rows.append(row)
            log(f"quantized {arch}/{mode}: rel_delta "
                f"{row['rel_logits_delta']} (tol {row['tolerance']}) "
                f"ok={row['ok']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run serving campaigns against a real multi-model fleet.")
    ap.add_argument("--campaign", action="append", default=None,
                    help="campaign YAML (repeatable; default: "
                         "config/campaigns/*.yaml)")
    ap.add_argument("--out", default=None, help="verdict JSON path")
    ap.add_argument("--work", default=None, help="work dir (default: tmp)")
    ap.add_argument("--round", type=int, default=1)
    ap.add_argument("--no-frontier", action="store_true")
    ap.add_argument("--no-quantized", action="store_true")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="KEY VALUE overrides of every campaign's serve config")
    args = ap.parse_args(argv)

    def log(msg):
        print(f"[serve_campaign] {msg}", flush=True)

    paths = args.campaign or sorted(
        glob.glob(os.path.join(ROOT, "config", "campaigns", "*.yaml"))
    )
    work = args.work or tempfile.mkdtemp(prefix="serve_campaign_")
    log(f"work dir {work}")

    from distribuuuu_tpu_torch.telemetry import spans

    spans.setup_telemetry(os.path.join(work, "telemetry"), rank=0)

    campaigns = [run_campaign(p, work, log, opts=args.opts) for p in paths]
    frontier = [] if args.no_frontier else measure_frontier(work, log, opts=args.opts)
    quantized = [] if args.no_quantized else quantized_report(log, opts=args.opts)

    ok = (
        all(c["ok"] for c in campaigns)
        and all(q["ok"] for q in quantized)
    )
    artifact = {
        "schema": 1,
        "generated_by": "python -m distribuuuu_tpu_torch.serve_campaign",
        "round": args.round,
        "cpu_count": os.cpu_count(),
        "opts": list(args.opts),
        "campaigns": campaigns,
        "frontier": frontier,
        "quantized": quantized,
        "ok": ok,
    }
    spans.close_telemetry()
    out = args.out or os.path.join(work, f"SERVE_CAMPAIGN_r{args.round:02d}.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    log(f"wrote {out} ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
