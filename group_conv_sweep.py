#!/usr/bin/env python3
"""Sweep the tilings of the bf16 grouped 3x3 conv kernel on one H100.

Run from the root of a checkout:  python3 group_conv_sweep.py [--out FILE]

At each bf16 shape of ``chip_smoke.GROUP_SHAPES``, every tiling the wgmma
body's launcher in csrc/group_conv.cu takes (one or two consumer
warpgroups; ring stages from 1 to what fits in shared memory, no more than
the K steps of 64) is held against ``group_conv3x3_plain`` within
``chip_smoke.GROUP_TOL`` and timed with ``chip_smoke.time_ms`` (CUDA
events, median of 25 launches). The tiling ``plan`` picks is marked, and
cuDNN's ``F.conv2d(groups=G)`` is timed beside it. One JSON line per
(shape, tiling), then the card's name and power limit. Exits 1 if a
tiling disagrees with the plain version or fails to launch.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs


def tilings(cg: int, fg: int):
    """Every (warpgroups, stages) the launcher takes at these group widths,
    stages up to the K steps."""
    from distribuuuu_tpu_torch.ops.cuda import group_conv as gc

    k_steps = -(-9 * cg // gc.KC)
    for wg in (1, 2):
        for stages in range(1, min(k_steps, gc.max_stages(wg, fg)) + 1):
            yield gc.GroupPlan(wg, stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("group_conv_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distribuuuu_tpu_torch.ops.cuda import group_conv as gc

    dev = torch.device("cuda", 0)
    out = open(args.out, "w") if args.out else None
    ok = True

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    for name, b, h, w, c, g, stride, dt, flipped in cs.GROUP_SHAPES:
        if dt != "bfloat16":
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, h, w, c, device=dev, generator=gen).to(torch.bfloat16)
        wt = torch.randn(c, c // g, 3, 3, device=dev, generator=gen) / (9 * c // g) ** 0.5
        wt = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        if flipped:
            wt = gc.flipped_weight(wt, g)
        cg = fg = c // g
        m = b * -(-h // stride) * -(-w // stride)
        ref = gc.group_conv3x3_plain(x, wt, stride, g)
        picked = gc.plan(m, g, cg, fg, stride)
        xc = x.permute(0, 3, 1, 2)
        bench, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, True
        cudnn = cs.time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wt, None, stride,
                                                                     1, 1, g))
        torch.backends.cudnn.benchmark = bench
        ops = gc.pass_flops(b, h, w, c, cg, stride)
        for tiling in tilings(cg, fg):
            row = {"shape": name, "B": b, "H": h, "W": w, "C": c, "G": g, "stride": stride,
                   "dx_weight": flipped, **tiling._asdict(), "plan": tiling == picked,
                   "cudnn_ms": cudnn}
            try:
                got = gc._launch(x, wt, stride, g, tiling)
                torch.cuda.synchronize()
                row["scaled_err"] = cs._scaled_err(got, ref)[1]
                row["ms"] = cs.time_ms(torch, lambda: gc._launch(x, wt, stride, g, tiling))
                row["tflops"] = ops / row["ms"] * 1e-9
            except RuntimeError as e:
                row["error"] = str(e)
            ok &= row.get("scaled_err", 1.0) <= cs.GROUP_TOL[dt]
            emit(row)
        del x, wt, ref, xc
    print(cs.card_line(), flush=True)
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
