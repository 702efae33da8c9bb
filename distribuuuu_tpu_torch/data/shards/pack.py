"""Packs an ImageFolder tree into record shards, or certifies a pack
(the port's counterpart of tools/make_shards.py: the same flags, output
lines and exit codes).

Pack (record order is the ImageFolder scan order, image bytes stored as
they are)::

    python -m distribuuuu_tpu_torch.data.shards.pack --src ./data/ILSVRC \
        --out ./data/ILSVRC-shards [--splits train,val] [--shard-mb 64]

Verify (re-reads every shard against the manifest: size, sha256, index
footer, each record's CRC, the record counts; exit status 1 on any
problem)::

    python -m distribuuuu_tpu_torch.data.shards.pack --out ./data/ILSVRC-shards --verify

Then train with::

    python -m distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml \
        DATA.FORMAT shards TRAIN.DATASET ./data/ILSVRC-shards \
        TEST.DATASET ./data/ILSVRC-shards
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from distribuuuu_tpu_torch.data.shards import format as shards_format


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="", help="ImageFolder root (root/split/class/*.jpg); "
                                              "required unless --verify")
    ap.add_argument("--out", required=True, help="shards root to write or verify")
    ap.add_argument("--splits", default="train,val", help="comma list of splits")
    ap.add_argument("--shard-mb", type=float, default=64.0,
                    help="target shard size in MiB (records are never split)")
    ap.add_argument("--verify", action="store_true",
                    help="verify an existing pack instead of packing")
    args = ap.parse_args(argv)

    splits = [s for s in args.splits.split(",") if s.strip()]
    if args.verify:
        all_ok = True
        for split in splits:
            t0 = time.perf_counter()
            ok, problems = shards_format.verify_split(os.path.join(args.out, split))
            all_ok &= ok
            print(json.dumps({"split": split, "ok": ok, "problems": problems,
                              "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
        if not all_ok:
            print("# VERIFY FAILED: do not train from this pack", flush=True)
        return 0 if all_ok else 1

    if not args.src:
        ap.error("--src is required when packing (omit only with --verify)")

    def progress(split, done, total):
        print(f"# {split}: {done}/{total} records", flush=True)

    t0 = time.perf_counter()
    manifests = shards_format.pack_imagefolder(
        args.src, args.out, splits=splits,
        target_bytes=max(1, int(args.shard_mb * 1024 * 1024)), progress=progress)
    for split, man_path in manifests.items():
        with open(man_path) as f:
            man = json.load(f)
        print(json.dumps({"split": split, "records": man["num_records"],
                          "classes": len(man["classes"]), "shards": len(man["shards"]),
                          "bytes": sum(s["size"] for s in man["shards"]),
                          "manifest": man_path}), flush=True)
    print(f"# packed in {time.perf_counter() - t0:.1f}s; certify with: python -m "
          f"distribuuuu_tpu_torch.data.shards.pack --out {args.out} --verify "
          f"--splits {args.splits}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
