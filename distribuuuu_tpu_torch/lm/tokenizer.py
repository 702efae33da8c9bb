"""Byte-level tokenizer (the port's copy of distribuuuu_tpu/lm/tokenizer.py).

Token ids are the input bytes (0..255), plus one reserved ``EOS_ID`` = 256
that marks document boundaries and ends generation. The vocabulary is
padded to ``VOCAB_SIZE`` = 320, a multiple of 64; ids in ``[257, 320)`` are
never produced by :meth:`ByteTokenizer.encode` and decode to nothing.
:meth:`ByteTokenizer.identity` is the fingerprint that token shards and
draft/target pairings compare; it equals the JAX package's.
"""

from __future__ import annotations

import numpy as np

VOCAB_BYTES = 256
EOS_ID = 256          # document boundary / end-of-sequence
VOCAB_SIZE = 320      # padded to a multiple of 64
TOKENIZER_NAME = "byte-v1"


class ByteTokenizer:
    """Stateless byte-level codec; identity lives in the class constants."""

    name = TOKENIZER_NAME
    vocab_size = VOCAB_SIZE
    eos_id = EOS_ID

    def encode(self, text: str | bytes) -> np.ndarray:
        """Text → uint16 token ids, one per utf-8 byte (no EOS appended)."""
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return np.frombuffer(data, np.uint8).astype(np.uint16)

    def decode(self, ids) -> str:
        """Token ids → text: byte ids render, EOS and padding ids drop,
        invalid utf-8 (a generation cut mid-codepoint) is replaced."""
        arr = np.asarray(ids).reshape(-1)
        data = bytes(int(i) for i in arr if 0 <= int(i) < VOCAB_BYTES)
        return data.decode("utf-8", errors="replace")

    def identity(self) -> dict:
        """The drift fingerprint manifests and pairings embed."""
        return {
            "tokenizer": self.name,
            "vocab_size": self.vocab_size,
            "eos_id": self.eos_id,
        }
