"""Decoder-only transformer LM (counterpart of distribuuuu_tpu/models/gpt.py).

Token embedding + learned positions → causal pre-norm blocks (the port's
``vit.Block`` with ``causal=True``) → LayerNorm → a per-token vocab head:
``[B, S]`` token ids give ``[B, S, vocab]`` logits. Modules: ``tok_embed``
(``nn.Embedding``), ``pos_embed`` ``[1, seq_len, dim]`` (a max-context table
sliced to the input length, so decoding runs shorter sequences against the
same parameters), ``blocks.N``, ``norm`` and ``head`` (fp32 under a bf16
compute dtype). The dtype policy is the ViT's: fp32 master weights, the
Linears in the compute dtype, LayerNorm statistics in fp32.

``lm/generate.py`` decodes by applying these same submodules against a KV
cache. ``gpt_nano_moe`` has a MoE FFN (``vit.MoeMlp``) in every 2nd block;
decoding runs it through the dense reference formulation, as the JAX
decoder does. Under a model axis (``parallel/partition/specs.
lm_spec_table``) the token embedding is split on its feature dim and
all-gathered after the lookup, and the head is vocab-parallel.
Sequence-sharded attention is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import Dense, LayerNorm, head_dtype
from distribuuuu_tpu_torch.models.vit import Block, CastModel, init_vit, moe_placement
from distribuuuu_tpu_torch.parallel import tp


class GPT(CastModel):
    """``vocab_size`` comes from ``MODEL.NUM_CLASSES`` (the byte tokenizer's
    320), ``seq_len`` from ``LM.SEQ_LEN``."""

    embed_shard = None  # the token embedding's feature split (place_model)

    def __init__(self, vocab_size: int = 320, seq_len: int = 256, dim: int = 192,
                 depth: int = 12, num_heads: int = 3, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "xla", device=None, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_every: int = 2, moe_impl: str = "partial",
                 moe_capacity_factor: float = 2.0):
        super().__init__()
        if dropout:
            raise ValueError(f"gpt dropout={dropout}: the port runs dropout 0 only (every "
                             "shipped config)")
        self.vocab_size, self.seq_len, self.dim = vocab_size, seq_len, dim
        self.depth, self.num_heads, self.mlp_ratio = depth, num_heads, mlp_ratio
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, dim, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, seq_len, dim, device=device))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, dtype, attn_impl, device=device, causal=True,
                  moe=moe)
            for moe in moe_placement(depth, moe_experts, moe_top_k, moe_every, moe_impl,
                                     moe_capacity_factor))
        self.norm = LayerNorm(dim, dtype, device)
        self.head = Dense(dim, vocab_size, device=device)

    def embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding in the compute dtype. flax casts
        the table and then gathers; gathering first gives the same values."""
        x = tp.gather(F.embedding(tokens.long(), self.tok_embed.weight), self.embed_shard)
        x = x.to(self.dtype)
        return x + self.pos_embed[0][positions].to(self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the head in ``head_dtype``."""
        x = self.norm(x)
        hd = head_dtype(x.dtype)
        return self.head(x.to(hd))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        _, s = tokens.shape
        if s > self.seq_len:
            raise ValueError(
                f"input length {s} exceeds the trained context "
                f"LM.SEQ_LEN={self.seq_len} (the learned position table)"
            )
        x = self.embed(tokens, torch.arange(s, device=tokens.device))
        for blk in self.blocks:
            x = blk(x)
        return self.logits(x)


def _gpt(num_classes, *, generator=None, device=None, **kw):
    with torch.device("meta"):
        model = GPT(vocab_size=num_classes, **kw)
    model.to_empty(device=device or "cpu")
    init_vit(model, generator or torch.Generator().manual_seed(0))
    return model


def gpt_nano(num_classes=320, **kw):
    """GPT-nano: 128 dim, 4 blocks, 4 heads (908,352 parameters at vocab
    320 and 256 positions)."""
    return _gpt(num_classes, **{"dim": 128, "depth": 4, "num_heads": 4, **kw})


def gpt_nano_moe(num_classes=320, **kw):
    """GPT-nano with a MoE FFN in every 2nd block (8 experts, top-2 by
    default; ``MODEL.MOE.*``)."""
    return _gpt(num_classes, **{"dim": 128, "depth": 4, "num_heads": 4, "moe_experts": 8,
                                **kw})
