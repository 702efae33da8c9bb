"""Language-model generation serving (counterpart of distribuuuu_tpu/lm/).

* ``tokenizer`` — the byte-level tokenizer;
* ``generate`` — KV-cache decoding over the GPT's own modules, the
  decode-attention kernel on the T=1 step, continuous batching over
  (batch, cache-len) tiles;
* ``service`` — the engine from the config and the streaming
  ``op="generate"`` socket protocol.

Training the gpt_* archs is not ported yet.
"""

from distribuuuu_tpu_torch.lm.tokenizer import ByteTokenizer  # noqa: F401
