#!/usr/bin/env python3
"""Sweep the tilings of the 16-bit flash-attention forward on one H100.

Run from the root of a checkout:  python3 flash_fwd_sweep.py [--out FILE]

At each bf16 shape of ``chip_smoke.FLASH_SHAPES`` (a head dim under 64
zero-padded to 64, as the autograd Function runs it), at ViT-S training
batch 64, and at head dim 128 beside the ViT-S training, eval and
4096-token ones, every tiling the forward's
launcher in csrc/flash_attention.cu takes (one or two consumer warpgroups
with key tiles of 64, or one with 128 at head dim 64; ring stages 1 to 4,
no more than the sequence has key tiles) is held against the plain forward within
``chip_smoke.FLASH_TOL`` and timed with ``chip_smoke.time_ms`` (CUDA events,
median of 25 launches). The tiling ``fwd_plan`` picks is marked, and
``F.scaled_dot_product_attention``'s forward is timed beside it. One JSON
line per (shape, tiling), then the card's name and power limit. Exits 1
if a tiling disagrees with the plain forward or fails to launch.
"""

from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs

EXTRA_SHAPES = [  # (name, batch, heads, length, head dim, dtype, causal)
    ("vit_s_train_b64", 64, 6, 196, 64, "bfloat16", False),  # between train b32 and eval b200
    ("vit_s_train_b32_d128", 32, 3, 196, 128, "bfloat16", False),
    ("vit_s_eval_b200_d128", 200, 3, 196, 128, "bfloat16", False),
    ("len_4096_b4_d128", 4, 3, 4096, 128, "bfloat16", False),
]


def tilings(L: int, d: int):
    for wg, kt in ((1, 64), (2, 64), (1, 128)) if d == 64 else ((1, 64), (2, 64)):
        for stages in range(1, min(4, -(-L // kt)) + 1):
            yield wg, kt, stages


def launch(torch, fa, q, k, v, scale, causal, plan):
    """One forward with the tiling ``plan`` (warpgroups, key tile, stages)."""
    bh, L, d = q.shape
    o = torch.empty_like(v)
    lse = torch.empty((bh, L), dtype=torch.float32, device=q.device)
    fa._call(fa._lib().flash_fwd_launch, "fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), bh=bh, L=L, d=d, dtype=q.dtype, causal=causal,
             scale=scale, device=q.device, plan=plan)
    return o, lse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = open(args.out, "w") if args.out else None
    ok = True

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    shapes = [s for s in cs.FLASH_SHAPES if s[5] != "float32"] + EXTRA_SHAPES
    for name, b, h, L, d, dt, causal in shapes:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b * h, L, d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
        # a head dim the kernels do not take runs zero-padded, as _Flash pads it
        dp = fa.kernel_head_dim(dtype, d)
        qk, kk, vk = (torch.nn.functional.pad(t, (0, dp - d)).contiguous() if dp != d else t
                      for t in (q, k, v))
        picked = tuple(fa.fwd_plan(b * h, L, dp, dtype)[1:])
        q4, k4, v4 = (t.view(b, h, L, d) for t in (q, k, v))
        sdpa = cs.time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        ops = fa.flops(b * h, L, d, causal)["forward"]
        for plan in tilings(L, dp):
            row = {"shape": name, "B": b, "H": h, "L": L, "D": d, "kernel_D": dp,
                   "causal": causal,
                   "warpgroups": plan[0], "key_tile": plan[1], "stages": plan[2],
                   "fwd_plan": plan == picked, "sdpa_ms": sdpa}
            try:
                o, lse = launch(torch, fa, qk, kk, vk, scale, causal, plan)
                torch.cuda.synchronize()
                row["scaled_err"] = max(cs._scaled_err(o[..., :d], o_ref)[1],
                                        cs._scaled_err(lse, lse_ref)[1])
                row["ms"] = cs.time_ms(torch, lambda: launch(torch, fa, qk, kk, vk, scale,
                                                             causal, plan))
                row["tflops"] = ops / row["ms"] * 1e-9
            except RuntimeError as e:
                row["error"] = str(e)
            ok &= row.get("scaled_err", 1.0) <= cs.FLASH_TOL[dt]
            emit(row)
    print(cs.card_line(), flush=True)
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
