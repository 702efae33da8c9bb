"""Sweep the tilings of the decode-attention kernel on one H100.

Run from the root of a checkout:
``python -m distribuuuu_tpu_torch.ops.cuda.decode_sweep [--out FILE]``

At each shape of ``chip_smoke.DECODE_SHAPES`` (lengths as chip_smoke makes
them), every tiling of the split body in a grid (splits 1–8; stages of
about 4, 8, 16 or 32 KB of K and V, whole key groups; 1–4 stages, no more
than a block's keys fill) is held against ``decode_attention_plain``
within ``chip_smoke.DECODE_TOL`` and timed with ``chip_smoke.time_ms``
(CUDA events, median of 25 calls).
Beside them: the first design (``decode_simple``), SDPA over the same
length mask, and the launch floors (an empty block; an empty kernel over
the plan's grid and clusters). The tiling ``plan`` picks is marked. One
JSON line per (shape, variant), then the card's name and power limit.
Exits 1 if a variant disagrees with the plain version or fails to launch.
"""

from __future__ import annotations

import argparse
import json
import sys

STAGES = 4  # the deepest ring swept


def tilings(b: int, h: int, c: int, d: int, dtype):
    """Every split-body tiling of the grid above, the plan's among them."""
    from distribuuuu_tpu_torch.ops.cuda import decode_attn as da

    ng = da.key_groups(d, dtype)
    row = 2 * d * dtype.itemsize
    seen = set()
    for splits in range(1, da.MAX_SPLITS + 1):
        keys = -(-c // splits)
        for stage_bytes in (4096, 8192, 16384, 32768):
            stage_keys = min(-(-keys // ng) * ng, max(ng, stage_bytes // row // ng * ng))
            for stages in range(1, min(STAGES, -(-keys // stage_keys)) + 1):
                t = da.DecodePlan("split", splits, stage_keys, stages)
                if t not in seen and da.ring_bytes(t, d, dtype) <= da.MAX_RING:
                    seen.add(t)
                    yield t
    p = da.plan(b, h, c, d, dtype)
    if p not in seen:
        yield p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_sweep: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from distribuuuu_tpu_torch.ops.cuda import decode_attn as da

    dev = torch.device("cuda", 0)
    F = torch.nn.functional
    out = open(args.out, "w") if args.out else None
    ok = True

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    for name, b, h, c, d, dt, lengths in cs.DECODE_SHAPES:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
        k, v = (torch.randn(b, h, c, d, device=dev, generator=gen).to(dtype) for _ in range(2))
        if lengths is None:
            lengths = np.random.default_rng(0).integers(0, c, b).tolist()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        ref = da.decode_attention_plain(q, k, v, lens, scale)
        best = da.plan(b, h, c, d, dtype)
        mask = (torch.arange(c, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
        base = {"shape": name, "B": b, "H": h, "C": c, "D": d, "dtype": dt}
        emit({**base, "variant": "reference",
              "sdpa_ms": cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
                  q[:, :, None], k, v, attn_mask=mask, scale=scale)),
              "floor_ms": cs.time_ms(torch, lambda: da.launch_floor(dev, 1, 1)),
              "cluster_floor_ms": cs.time_ms(
                  torch, lambda: da.launch_floor(dev, b, h, best.splits)),
              "plan": best._asdict()})
        for t in [da.DecodePlan("simple", 1, 0, 0), *tilings(b, h, c, d, dtype)]:
            row = {**base, "variant": t.body, **t._asdict(), "is_plan": t == best}
            try:
                got = da.decode_attention_kernel(q, k, v, lens, scale, tiling=t)
                torch.cuda.synchronize()
                row["scaled_err"] = cs._scaled_err(got, ref)[1]
                row["ms"] = cs.time_ms(torch, lambda: da.decode_attention_kernel(
                    q, k, v, lens, scale, tiling=t))
            except RuntimeError as e:
                row["error"] = str(e)
                ok = False
            else:
                if not row["scaled_err"] <= cs.DECODE_TOL[dt]:
                    row["error"] = f"scaled error {row['scaled_err']} > {cs.DECODE_TOL[dt]}"
                    ok = False
            emit(row)
        del q, k, v, lens, ref, mask
    print(cs.card_line(), flush=True)
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
