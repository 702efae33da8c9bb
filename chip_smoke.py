#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (distribuuuu_tpu_torch) on one H100.

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel of the serving path from csrc/ (sm_90a).
3. Kernel phase: each kernel's wrapper at the shapes the ResNet-50
   serving path gives it (batch 8, 224², bf16), plus a small ragged f32
   shape, held against its plain PyTorch version on the card; times the
   kernel, the plain version and one library call (CUDA events), and
   computes the bound (bytes over 3.35 TB/s vs operations over the
   peak rate of their type).
4. Slice phase: ResNet-50 (1000 classes, 224², bf16, weights from
   RNG_SEED) through ``engine_from_cfg`` on cuda:0 with
   config/resnet50.yaml; two bursts of 64 seeded uint8 requests through
   ``submit`` with buckets [1, 2, 4, 8] (img/s and latency are the second
   burst's; the first is reported apart). Checks that every kernel of the path ran
   (33 conv-epilogue launches per forward, warm-ups included) and that
   the card's logits agree with the port's CPU run in f32.
5. Prints the ``{"kernels": [...]}`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero. Exits non-zero, printing no result,
without CUDA or outside a checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 CUDA cores
BF16_TOL = 0.0625  # max-abs, pinned as in tests/test_pallas_kernels.py
F32_TOL = 1e-5
# end-to-end bf16 card vs f32 CPU: 50+ layers of bf16 rounding on the card
SLICE_REL_TOL = 0.05  # max |logit diff| / max |CPU logit|
SLICE_TOP1_MIN = 0.9  # share of requests with the same top-1 class
N_REQUESTS = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def resnet50_sites(batch: int, im: int):
    """(M, K, N, act) of the 33 fused conv-epilogue sites of one
    ResNet-50 forward, in order: per bottleneck conv1 (relu; at the input
    resolution, before the strided 3x3) and conv3 (id), plus the stride-1
    downsample of stage 1 (id). Strided downsamples do not qualify."""
    sites, res, in_ch = [], im // 4, 64
    for stage, (feats, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            sites.append((batch * res * res, in_ch, feats, "relu"))
            res //= stride
            sites.append((batch * res * res, feats, feats * 4, "id"))
            if i == 0 and stride == 1:
                sites.append((batch * res * res, in_ch, feats * 4, "id"))
            in_ch = feats * 4
    return sites


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call: CUDA events around each call, with
    the stream held by a sleep kernel while the host enqueues, so host
    launch overhead does not enter the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(50_000_000)
    evs[0].record()
    for i in range(reps):
        fn()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1]) for i in range(reps))


def bound(m, k, n, dtype, torch, ce):
    nbytes = ce.pass_bytes(m, k, n, dtype, dtype)
    flops = 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def kernel_phase(torch, ce, dev):
    """conv1x1_bn_act against its plain version at every distinct site
    shape of the serving path, and at a ragged f32 shape."""
    sites = resnet50_sites(8, 224)
    shapes = {}
    for s in sites:
        shapes[s] = shapes.get(s, 0) + 1
    cases = [(*s, torch.bfloat16, cnt) for s, cnt in shapes.items()]
    cases.append((50, 48, 96, "silu", torch.float32, 0))  # ragged M, N, K
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    for m, k, n, act, dtype, count in cases:
        x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
        w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(dtype)
        a = 1.0 + 0.1 * torch.randn(n, device=dev, generator=gen)
        c = 0.1 * torch.randn(n, device=dev, generator=gen)
        out = ce.conv1x1_bn_act(x, w, a, c, act)
        ref = ce.conv1x1_bn_act_plain(x, w, a, c, act)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        bms, by, nbytes = bound(m, k, n, dtype, torch, ce)
        row = {
            "phase": "kernel", "name": "conv1x1_bn_act", "M": m, "K": k, "N": n,
            "act": act, "dtype": str(dtype).split(".")[-1], "sites_per_forward": count,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, lambda: ce.conv1x1_bn_act(x, w, a, c, act)),
            "plain_ms": time_ms(torch, lambda: ce.conv1x1_bn_act_plain(x, w, a, c, act)),
            "library_ms": time_ms(torch, lambda: torch.matmul(x, w)),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
        }
        emit(row)
        if not err <= tol:
            raise AssertionError(f"conv1x1_bn_act {m}x{k}x{n} {act} {dtype}: "
                                 f"max abs err {err} > {tol}")
        worst = max(worst, err)
        rows.append(row)
    return rows, worst


def slice_phase(torch, ce, n_requests: int):
    """ResNet-50 serving through the port's engine on cuda:0, checked
    against the port's CPU forward in f32 on the same weights."""
    import numpy as np

    import distribuuuu_tpu_torch.config as config
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.serve import ServeMetrics, engine_from_cfg

    config.reset_cfg()
    config.merge_from_file("config/resnet50.yaml")
    cfg.merge_from_list([
        "DEVICE.PLATFORM", "auto", "DEVICE.COMPUTE_DTYPE", "bfloat16",
        "RNG_SEED", 0, "SERVE.DEVICE", 0, "SERVE.MAX_BATCH", 8,
        "SERVE.BUCKET_SIZES", [1, 2, 4, 8], "SERVE.MAX_QUEUE", 2 * n_requests,
        "SERVE.MAX_WAIT_MS", 2.0,
    ])
    im = cfg.TRAIN.IM_SIZE
    images = np.random.default_rng(0).integers(0, 256, (n_requests, im, im, 3), np.uint8)

    ce.conv1x1_bn_act.launches = 0
    t_build = time.perf_counter()
    engine = engine_from_cfg()
    t_build = time.perf_counter() - t_build
    engine.start()
    walls, batches = [], 0
    for burst in range(2):  # the first burst meets the threads' first CUDA calls
        engine.metrics = ServeMetrics()
        t0 = time.perf_counter()
        futs = [engine.submit(img) for img in images]
        logits = np.stack([f.result(timeout=300) for f in futs])
        walls.append(time.perf_counter() - t0)
        batches += engine.metrics.snapshot()["batches"]
    wall = walls[-1]
    engine.drain()
    launches = ce.conv1x1_bn_act.launches
    stats = engine.stats()

    forwards = batches + engine.n_compiles
    sites = sum(u.fused for u in engine.model.conv_units())
    if sites != 33 or launches != 33 * forwards:
        raise AssertionError(
            f"conv epilogue launches {launches} != 33 x {forwards} forwards "
            f"({batches} batches + {engine.n_compiles} warm-ups); "
            f"{sites} fused sites"
        )

    # the same weights through the port on the CPU, in f32
    ref = build_model("resnet50", num_classes=cfg.MODEL.NUM_CLASSES, dtype=torch.float32)
    ref.load_state_dict({k: v.cpu() for k, v in engine.model.state_dict().items()})
    ref.eval()
    with torch.inference_mode():
        cpu = np.concatenate([
            ref(normalize_on_device(torch.from_numpy(images[i:i + 16]))).numpy()
            for i in range(0, n_requests, 16)
        ])
    if logits.shape != (n_requests, cfg.MODEL.NUM_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite "
                             f"{bool(np.isfinite(logits).all())}")
    rel = float(np.abs(logits - cpu).max() / np.abs(cpu).max())
    top1 = float((logits.argmax(1) == cpu.argmax(1)).mean())
    res = {
        "phase": "slice", "arch": cfg.MODEL.ARCH, "dtype": "bfloat16", "im_size": im,
        "requests": n_requests, "batches": stats["batches"], "forwards": forwards,
        "warmups": engine.n_compiles,
        "conv_epilogue_launches": launches, "engine_build_s": t_build,
        "first_burst_wall_s": walls[0], "first_burst_img_per_s": n_requests / walls[0],
        "img_per_s": n_requests / wall, "wall_s": wall,
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "batch_occupancy": stats["batch_occupancy"], "mean_batch_ms": stats["mean_batch_ms"],
        "rel_err_vs_cpu_f32": rel, "rel_tol": SLICE_REL_TOL,
        "top1_agreement": top1, "top1_min": SLICE_TOP1_MIN,
        "logit_scale": float(np.abs(cpu).max()),
    }
    emit(res)
    if not (rel <= SLICE_REL_TOL and top1 >= SLICE_TOP1_MIN):
        raise AssertionError(f"card vs CPU logits: rel err {rel} (tol {SLICE_REL_TOL}), "
                             f"top-1 agreement {top1} (min {SLICE_TOP1_MIN})")
    return launches, engine.model


def profile_phase(torch, model, batch: int, im: int, iters: int = 10):
    """Where the time of one bf16 forward at ``batch`` goes: its host wall
    time (synchronised, no profiler), and from a torch.profiler trace the
    device time by kernel kind and the device's idle share of the traced
    window (host launch overhead shows up as idle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distribuuuu_tpu_torch.data.transforms import normalize_on_device

    dev = next(model.parameters()).device
    x = normalize_on_device(torch.randint(0, 256, (batch, im, im, 3), dtype=torch.uint8,
                                          device=dev))
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
    kinds, spans, n_kernels = {}, [], 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        us = e.time_range.elapsed_us()
        name = e.name
        kind = ("conv_epilogue" if "epilogue_gemm" in name
                else "cudnn_conv" if any(s in name for s in ("conv", "xmma", "cudnn", "implicit"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3 / iters
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        raise AssertionError("the profiler recorded no device kernels")
    spans.sort()
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    emit({"phase": "profile", "batch": batch, "iters": iters,
          "forward_wall_ms": wall_ms / iters,
          "device_ms_per_forward_by_kind": kinds,
          "kernels_per_forward": n_kernels / iters,
          "device_busy_ms_per_forward": busy / 1e3 / iters,
          "device_idle_share": 1.0 - busy / window})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one bf16 ResNet-50 forward at batch 8")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    try:
        from distribuuuu_tpu_torch.ops.cuda import _build
        from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build("conv_epilogue")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dict(_build.build_seconds)})

    rows, worst = kernel_phase(torch, ce, dev)
    launches, model = slice_phase(torch, ce, N_REQUESTS)
    if args.profile:
        profile_phase(torch, model, 8, 224)

    # per-forward totals over the 33 sites (sites_per_forward weights)
    def total(key):
        return sum(r[key] * r["sites_per_forward"] for r in rows)

    t_bytes = sum(r["bytes"] * r["sites_per_forward"] for r in rows) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(2 * r["M"] * r["K"] * r["N"] * r["sites_per_forward"] for r in rows
                if r["sites_per_forward"]) / PEAK_FLOPS["bfloat16"] * 1e3
    emit({"kernels": [{
        "name": "conv1x1_bn_act",
        "route": "cuda",
        "source": "distribuuuu_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": "distribuuuu_tpu/ops/pallas/conv_epilogue.py:121",
        "launches": launches,
        "max_abs_err": worst,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total("library_ms"),
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
