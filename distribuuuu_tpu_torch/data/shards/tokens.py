"""Token shards: packed LM sequences in the shards format (the port's copy
of distribuuuu_tpu/data/shards/tokens.py).

Documents → byte tokens → one ``EOS`` after each document → the joined
stream cut into fixed ``pack_len + 1``-token records (input ``[:-1]``,
next-token targets ``[1:]``: a record is one training example with no
dependency on another, so any order is valid). The container is
``format.py``'s as it is: CRC'd records, the index footer, the manifest
committed last, so ``--verify``, footer recovery, ``FAULTS.TRUNCATE_SHARD``
and the loader's retries and ``DATA.SKIP_CORRUPT`` apply unchanged.

A record's ``label`` counts the document boundaries inside it, its ``key``
is ``seq-<n>``, its payload the little-endian uint16 token array. The
manifest adds ``kind="tokens"`` (the species guard: the image reader
refuses such a pack, this one an image pack), ``pack_len``,
``total_tokens`` and the tokenizer identity, which
:class:`TokenShardDataset` checks against the live config. The bytes are
the JAX package's: a pack either side writes, the other reads.

The exact mid-epoch resume is the image shards' (``RecordShards`` and its
window-shuffled order); :meth:`TokenShardDataset.identity` rides the
loader's cursor, so a pack or tokenizer change refuses a saved cursor.
"""

from __future__ import annotations

import numpy as np

from distribuuuu_tpu_torch.data.shards.format import (
    ShardFormatError,
    ShardReadError,
    ShardWriter,
    write_shard_manifest,
)
from distribuuuu_tpu_torch.data.shards.reader import RecordShards
from distribuuuu_tpu_torch.lm.tokenizer import ByteTokenizer

TOKEN_DTYPE = np.dtype("<u2")  # little-endian uint16 payload on disk
PACKER = "python -m distribuuuu_tpu_torch.data.shards.pack_tokens"


def pack_token_stream(docs, pack_len: int, tokenizer: ByteTokenizer | None = None):
    """Documents → fixed-length packed sequences. Yields ``(seq, n_docs)``:
    ``seq`` a ``pack_len + 1`` uint16 array of the EOS-joined stream,
    ``n_docs`` the EOS tokens inside it. The trailing partial window is
    dropped (a short record would break the fixed batch shape)."""
    tok = tokenizer or ByteTokenizer()
    if pack_len < 1:
        raise ValueError(f"pack_len must be >= 1, got {pack_len}")
    width = pack_len + 1
    buf = np.empty((0,), np.uint16)
    for doc in docs:
        ids = tok.encode(doc) if not isinstance(doc, np.ndarray) else doc
        buf = np.concatenate([buf, ids.astype(np.uint16), np.array([tok.eos_id], np.uint16)])
        while len(buf) >= width:
            seq, buf = buf[:width].copy(), buf[width:]
            yield seq, int((seq == tok.eos_id).sum())


def write_token_shards(out_dir: str, seqs, pack_len: int, *,
                       tokenizer: ByteTokenizer | None = None,
                       target_bytes: int = 4 * 1024 * 1024, source: str = "") -> str:
    """Write packed sequences into ``out_dir`` (one split directory) and
    commit the token manifest; returns its path. A corpus too short for
    one record is refused here, before any shard is opened."""
    tok = tokenizer or ByteTokenizer()
    writer = ShardWriter(out_dir, target_bytes=target_bytes)
    n = 0
    for seq, n_docs in seqs:
        seq = np.asarray(seq, TOKEN_DTYPE)
        if len(seq) != pack_len + 1:
            raise ValueError(f"sequence {n} has {len(seq)} tokens, want pack_len+1="
                             f"{pack_len + 1}")
        writer.add(seq.tobytes(), int(n_docs), f"seq-{n:08d}")
        n += 1
    if n == 0:
        raise ValueError(
            f"{out_dir}: 0 complete records at pack_len={pack_len} — every "
            f"record needs pack_len+1={pack_len + 1} tokens and the "
            "EOS-joined corpus stream is shorter than one record (the "
            "trailing partial window is dropped by contract); lower "
            "--pack-len or grow the corpus"
        )
    shards = writer.close()
    return write_shard_manifest(
        out_dir, shards, classes=[], target_bytes=target_bytes, source=source,
        extra={"kind": "tokens", "pack_len": int(pack_len),
               "total_tokens": n * (pack_len + 1), **tok.identity()})


class TokenShardDataset(RecordShards):
    """``dataset[i]`` is ``(input_tokens [S] int32, next_tokens [S]
    int32)``, the loader's ``(image, label)`` contract, so batches arrive
    as ``{"image": [B, S] int32, "label": [B, S] int32, "mask": [B]}``.
    ``BATCH_DTYPE`` keeps the stacked payload int32 (no image cast). The
    refusals are the JAX package's letter for letter; the repack command
    they name writes the same bytes as ``pack_tokens``."""

    KIND = "tokens"
    BATCH_DTYPE = np.int32
    PACKER = PACKER

    def __init__(self, root: str, split: str, seq_len: int, num_classes: int | None = None):
        self._open_split(root, split)
        self.seq_len = int(seq_len)
        pack = int(self.manifest.get("pack_len", -1))
        if pack != self.seq_len:
            raise ShardFormatError(
                f"{self.dir}: token shards are packed at pack_len={pack} "
                f"but LM.SEQ_LEN={self.seq_len} — set LM.SEQ_LEN {pack} or "
                f"repack: python tools/make_token_shards.py --src <corpus> "
                f"--out <root> --pack-len {self.seq_len}"
            )
        self.tokenizer = ByteTokenizer()
        live = self.tokenizer.identity()
        packed = {k: self.manifest.get(k) for k in live}
        if packed != live:
            raise ShardFormatError(
                f"{self.dir}: tokenizer identity drift — pack says "
                f"{packed}, live tokenizer is {live}; a cursor/weights "
                "trained on one cannot continue on the other (repack with "
                "tools/make_token_shards.py)"
            )
        if num_classes is not None and int(num_classes) < live["vocab_size"]:
            raise ShardFormatError(
                f"MODEL.NUM_CLASSES={num_classes} is smaller than the "
                f"pack's tokenizer vocab {live['vocab_size']} — the head "
                "could never emit every token id; set MODEL.NUM_CLASSES "
                f"{live['vocab_size']} (the gpt_*.yaml default)"
            )

    def identity(self) -> dict:
        """Rides the loader's exact-resume cursor: a restored cursor is
        honoured only when the live pack and tokenizer identity match."""
        return {"kind": "tokens", "pack_len": self.seq_len, **self.tokenizer.identity()}

    def seq_tokens(self, idx: int) -> np.ndarray:
        """Record ``idx``'s whole ``[pack_len + 1]`` uint16 sequence."""
        payload, _, _ = self.record(int(idx))
        seq = np.frombuffer(payload, TOKEN_DTYPE)
        if len(seq) != self.seq_len + 1:
            raise ShardReadError(f"record {idx}: {len(seq)} tokens, manifest pack_len says "
                                 f"{self.seq_len + 1}")
        return seq

    def __getitem__(self, idx: int):
        seq = self.seq_tokens(int(idx)).astype(np.int32)
        return seq[:-1], seq[1:]
