"""Packs a text corpus into token shards, or certifies a pack (the port's
counterpart of tools/make_token_shards.py: the same flags, output lines
and exit codes, and packs byte-identical to it).

Documents are tokenized by the byte tokenizer (``lm/tokenizer.py``),
joined with one EOS each, and cut into ``--pack-len + 1``-token records
(``data/shards/tokens.py``). ``--src`` is a directory, where every
``*.txt`` file (recursive, sorted) is one document, or one file, where
every blank-line-separated paragraph is one. ``--val-frac`` holds out
every k-th document into the ``val`` split (no RNG: a repack gives the
same split).

Pack::

    python -m distribuuuu_tpu_torch.data.shards.pack_tokens --src ./corpus \
        --out ./data/tokens [--pack-len 256] [--shard-mb 4] [--val-frac 0.05]

Verify (size, sha256, footer and the CRC walk of every shard; exit status
1 on any problem)::

    python -m distribuuuu_tpu_torch.data.shards.pack_tokens --out ./data/tokens --verify

Then train with::

    python -m distribuuuu_tpu_torch.train_net --cfg config/gpt_nano.yaml \
        TRAIN.DATASET ./data/tokens TEST.DATASET ./data/tokens
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def iter_documents(src: str):
    """Documents from a corpus path (see the module docstring)."""
    if os.path.isdir(src):
        paths = sorted(glob.glob(os.path.join(src, "**", "*.txt"), recursive=True))
        if not paths:
            raise SystemExit(f"no *.txt files under {src}")
        for p in paths:
            with open(p, "rb") as f:
                yield f.read()
        return
    with open(src, "rb") as f:
        text = f.read()
    for para in text.split(b"\n\n"):
        if para.strip():
            yield para


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="", help="corpus: a dir of *.txt docs or one text file; "
                                              "required unless --verify")
    ap.add_argument("--out", required=True, help="token-shards root to write/verify")
    ap.add_argument("--pack-len", type=int, default=256,
                    help="sequence length S (records hold S+1 tokens for the next-token "
                         "shift); must equal LM.SEQ_LEN at train time")
    ap.add_argument("--shard-mb", type=float, default=4.0, help="target shard size in MiB")
    ap.add_argument("--val-frac", type=float, default=0.05,
                    help="fraction of documents held out as the val split (deterministic "
                         "every-k-th; 0 = train only)")
    ap.add_argument("--verify", action="store_true",
                    help="verify an existing pack instead of packing")
    args = ap.parse_args(argv)

    from distribuuuu_tpu_torch.data.shards import format as shards_format
    from distribuuuu_tpu_torch.data.shards import tokens as token_shards
    from distribuuuu_tpu_torch.lm.tokenizer import ByteTokenizer

    if args.verify:
        all_ok = True
        for split in ("train", "val"):
            split_dir = os.path.join(args.out, split)
            if not os.path.isdir(split_dir):
                continue
            t0 = time.perf_counter()
            ok, problems = shards_format.verify_split(split_dir)
            all_ok &= ok
            print(json.dumps({"split": split, "ok": ok, "problems": problems,
                              "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
        if not all_ok:
            print("# VERIFY FAILED — do not train from this pack", flush=True)
        return 0 if all_ok else 1

    if not args.src:
        ap.error("--src is required when packing (omit only with --verify)")
    target_bytes = max(1, int(args.shard_mb * 1024 * 1024))
    tok = ByteTokenizer()
    docs = list(iter_documents(args.src))
    every = int(round(1.0 / args.val_frac)) if args.val_frac > 0 else 0
    split_docs = {
        "train": [d for i, d in enumerate(docs) if not every or (i + 1) % every],
        "val": [d for i, d in enumerate(docs) if every and not (i + 1) % every],
    }
    t0 = time.perf_counter()
    for split, sdocs in split_docs.items():
        if not sdocs:
            continue
        split_dir = os.path.join(args.out, split)
        man_path = token_shards.write_token_shards(
            split_dir, token_shards.pack_token_stream(sdocs, args.pack_len, tok),
            args.pack_len, tokenizer=tok, target_bytes=target_bytes,
            source=os.path.abspath(args.src))
        with open(man_path) as f:
            man = json.load(f)
        print(json.dumps({"split": split, "documents": len(sdocs),
                          "sequences": man["num_records"], "tokens": man["total_tokens"],
                          "pack_len": man["pack_len"], "tokenizer": man["tokenizer"],
                          "shards": len(man["shards"]), "manifest": man_path}), flush=True)
    print(f"# packed in {time.perf_counter() - t0:.1f}s — certify with: python -m "
          f"distribuuuu_tpu_torch.data.shards.pack_tokens --out {args.out} --verify",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
