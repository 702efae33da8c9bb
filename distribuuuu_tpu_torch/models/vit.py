"""Vision Transformer (counterpart of distribuuuu_tpu/models/vit.py).

Patch embed → pre-norm transformer blocks → LayerNorm → mean over tokens →
head, on NHWC input ``[B, H, W, 3]``; global average pooling instead of a
class token, as the JAX model. Modules carry timm's names
(``patch_embed.proj``, ``pos_embed``, ``blocks.N.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm``, ``head``), except that the
final norm is ``norm`` (the JAX model normalises before the token mean,
where timm's pooled models have ``fc_norm`` after it).

The dtype policy is the JAX package's: fp32 master weights, the patch
conv and the Linears in the compute dtype (cast every forward in
training, once per entry into eval by ``prepare()``), LayerNorm statistics
in fp32 (``layers.LayerNorm``), the head in fp32.

Attention (``attn_impl``, from ``DEVICE.ATTN_IMPL``):
  * ``xla``: dense, the score → softmax → weighted-sum region in fp32
    whatever the compute dtype, cast back at the end;
  * ``flash``: the flash kernels (``ops/cuda/flash_attention.py``) on the
    card, their plain versions on the CPU;
  * ``blockwise``: the O(L·chunk) online-softmax loop
    (``ops/ring_attention.py``), plain PyTorch;
  * ``auto``: ``flash`` at ``FLASH_MIN_SEQ`` tokens or more with dropout 0,
    ``xla`` below;
  * ``ring``/``ulysses`` (sequence-sharded) and the pipelined variant are
    not ported.

The MoE variant (``vit_tiny_moe``; JAX ``MoeMlp``) puts a mixture-of-experts
FFN (:class:`MoeMlp`, ``ops/moe.py``) in every ``moe_every``-th block,
``blocks.N.mlp.{gate, w_in, b_in, w_out, b_out}`` in the JAX layout. Its
forward keeps the block's balancing loss (``aux``) and, under dispatch,
the dropped fraction (``dropped``) on the module for the trainer.

Tensor and expert parallelism (``parallel/partition/specs.place_model``):
the Linears become column-parallel over the model axis (``parallel/tp.py``)
and the MoE layers hold their expert-axis shard of the experts; built whole
on every rank from one seed, then split, so a sharded model starts from the
unsharded one's weights.

``causal`` (``Attention``, ``Block``) masks keys past the query's position
under every impl, for the decoder-only LM (``models/gpt.py``): the dense
region with a ``tril`` mask at −1e30, ``flash`` and ``blockwise`` with
their own ``causal`` flag.

Dropout is 0 in every shipped config; the port takes 0 only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.models.layers import Dense, LayerNorm, gelu, head_dtype
from distribuuuu_tpu_torch.ops import moe as moe_ops
from distribuuuu_tpu_torch.ops import ring_attention as ra
from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa
from distribuuuu_tpu_torch.parallel import tp

ATTN_IMPLS = ("auto", "xla", "flash", "blockwise", "ring", "ulysses")
PARALLEL = "Parallel layouts beyond DP"


class _Cast:
    """Weight and bias used in ``self.dtype``: cast on every forward in
    training (a differentiable cast, so the gradient reaches the fp32
    master), and once per entry into eval (``prepare``, or lazily)."""

    def prepare(self) -> None:
        self._cache = (self.weight.detach().to(self.dtype), self.bias.detach().to(self.dtype))

    def _weights(self):
        if self.training:
            return self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self._cache is None:
            self.prepare()
        return self._cache


class Linear(_Cast, nn.Linear):
    """A block Linear in the compute dtype; column-parallel under a
    ``shard`` (``parallel/tp.linear``)."""

    shard = None
    bias_sharded = False

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype, self._cache = dtype, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.linear(x.to(self.dtype), *self._weights(), self.shard, self.bias_sharded)


class PatchConv(_Cast, nn.Conv2d):
    """The patch embedding: a ``patch``×``patch`` conv of stride ``patch``
    with bias, NHWC in, ``[B, tokens, dim]`` out (row-major token order)."""

    def __init__(self, dim: int, patch: int, dtype: torch.dtype, device=None):
        super().__init__(3, dim, patch, patch, device=device)
        self.dtype, self._cache = dtype, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.kernel_size[0]
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), *self._weights(), stride=p)
        return y.permute(0, 2, 3, 1).reshape(b, (h // p) * (w // p), -1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.proj = PatchConv(dim, patch, dtype, device)

    def forward(self, x):
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype, device)
        self.fc2 = Linear(hidden, dim, dtype, device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class MoeMlp(_Cast, nn.Module):
    """Mixture-of-experts FFN (JAX ``models/vit.MoeMlp``): ``num_experts``
    GELU FFNs of width ``hidden`` routed top-``top_k``. With no expert
    shard (``ep``, set by ``place_model``) it runs the dense reference
    formulation, as JAX at an expert axis of 1; with one, ``impl``
    ``partial`` or ``dispatch`` over the shard's group. In training each
    forward keeps ``aux``, the balancing loss over the global batch (its
    ``f`` and ``p`` averaged over the data group ``data`` before the
    product), and under dispatch ``dropped``."""

    def __init__(self, dim: int, hidden: int, num_experts: int, top_k: int,
                 dtype: torch.dtype, impl: str = "partial", capacity_factor: float = 2.0,
                 device=None):
        super().__init__()
        if impl not in ("partial", "dispatch"):
            raise ValueError(f"MODEL.MOE.IMPL must be 'partial' or 'dispatch', got {impl!r}")
        e = num_experts
        self.gate = nn.Parameter(torch.zeros(dim, e, device=device))
        self.w_in = nn.Parameter(torch.zeros(e, dim, hidden, device=device))
        self.b_in = nn.Parameter(torch.zeros(e, hidden, device=device))
        self.w_out = nn.Parameter(torch.zeros(e, hidden, dim, device=device))
        self.b_out = nn.Parameter(torch.zeros(e, dim, device=device))
        self.top_k, self.dtype, self.impl = top_k, dtype, impl
        self.capacity_factor = capacity_factor
        self.ep = self.data = None
        self.aux = self.dropped = None
        self._cache = None

    def prepare(self) -> None:
        self._cache = {"gate": self.gate.detach(),
                       **{k: getattr(self, k).detach().to(self.dtype)
                          for k in moe_ops.EXPERT_KEYS}}

    def _params(self) -> dict:
        if self.training:
            return {k: getattr(self, k) for k in ("gate", *moe_ops.EXPERT_KEYS)}
        if self._cache is None:
            self.prepare()
        return self._cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        x = x.to(self.dtype).reshape(b * s, d)
        params = self._params()
        if self.ep is None:
            out = moe_ops.moe_ffn_reference(params, x, self.top_k)
        elif self.impl == "dispatch":
            out, self.dropped = moe_ops.moe_ffn_dispatch(params, x, self.ep, self.top_k,
                                                         self.capacity_factor, self.data)
        else:
            out = moe_ops.moe_ffn_partial(params, x, self.ep, self.top_k)
        if self.training:
            f, p = moe_ops.balance_stats(moe_ops.gating_probs(x, params["gate"]), self.top_k)
            if self.data is not None:
                f, p = tp.data_mean(f, self.data), tp.data_mean(p, self.data)
            self.aux = moe_ops.aux_from_balance_stats(f, p)
        return out.reshape(b, s, d)


class Attention(nn.Module):
    # sequence length at or above which "auto" picks the flash kernels
    FLASH_MIN_SEQ = 1024

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, attn_impl: str = "xla",
                 device=None, causal: bool = False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"vit attn_impl must be one of {ATTN_IMPLS}; got {attn_impl!r}")
        self.num_heads, self.dtype, self.attn_impl = num_heads, dtype, attn_impl
        self.causal = causal
        self.qkv = Linear(dim, 3 * dim, dtype, device)
        self.proj = Linear(dim, dim, dtype, device)

    @staticmethod
    def resolve_impl(attn_impl: str, seq_len: int, dropout: float = 0.0) -> str:
        """'auto' → 'flash' at ≥ FLASH_MIN_SEQ tokens with dropout 0, 'xla'
        below; any other impl as it is."""
        if attn_impl != "auto":
            return attn_impl
        if seq_len >= Attention.FLASH_MIN_SEQ and dropout == 0:
            return "flash"
        return "xla"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        h = self.num_heads
        impl = self.resolve_impl(self.attn_impl, s)
        qkv = self.qkv(x).reshape(b, s, 3, h, dim // h).permute(2, 0, 3, 1, 4)  # [3,B,H,S,D]
        q, k, v = qkv[0], qkv[1], qkv[2]
        if impl in ("ring", "ulysses"):
            out = (ra.ring_attention if impl == "ring" else ra.ulysses_attention)(q, k, v)
        elif impl == "flash":
            out = fa.flash_attention(q, k, v, causal=self.causal)
        elif impl == "blockwise":
            out = ra.blockwise_attention(q, k, v, causal=self.causal)
        else:  # dense, in fp32 (bf16 logits would lose softmax mass at long S)
            sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dim // h) ** -0.5
            if self.causal:
                tril = torch.ones((s, s), dtype=torch.bool, device=sc.device).tril()
                sc = torch.where(tril, sc, -1e30)
            w = torch.softmax(sc, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
        out = out.to(self.dtype).transpose(1, 2).reshape(b, s, dim)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype,
                 attn_impl: str, device=None, causal: bool = False, moe: dict | None = None):
        """``moe``: the :class:`MoeMlp` keywords (``num_experts``,
        ``top_k``, ``impl``, ``capacity_factor``) for a MoE FFN, None for
        the dense one."""
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, device)
        self.attn = Attention(dim, num_heads, dtype, attn_impl, device, causal)
        self.norm2 = LayerNorm(dim, dtype, device)
        hidden = int(dim * mlp_ratio)
        self.mlp = (Mlp(dim, hidden, dtype, device) if moe is None
                    else MoeMlp(dim, hidden, dtype=dtype, device=device, **moe))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CastModel(nn.Module):
    """A model whose ``_Cast`` layers hold compute-dtype copies of their
    weights in eval (the ViT and the GPT)."""

    def _cast_modules(self):
        return [m for m in self.modules() if isinstance(m, _Cast)]

    def train(self, mode: bool = True):
        """Set the mode and drop the eval weight cache (rebuilt from the
        current weights at the next eval)."""
        super().train(mode)
        for m in self._cast_modules():
            m._cache = None
        return self

    def prepare(self):
        """Cast the Linears' (and the patch conv's and the experts')
        weights to the compute dtype once per entry into eval (the serving
        engines call this at build; otherwise the first eval forward
        does)."""
        for m in self._cast_modules():
            m.prepare()
        return self

    def moe_layers(self) -> list:
        return [m for m in self.modules() if isinstance(m, MoeMlp)]


def moe_placement(depth: int, moe_experts: int, moe_top_k: int, moe_every: int,
                  moe_impl: str, moe_capacity_factor: float) -> list:
    """Each block's ``Block(moe=...)``: the MoE keywords in every
    ``moe_every``-th block (odd indices at the default 2, the GShard
    placement), None elsewhere and everywhere at ``moe_experts`` 0."""
    moe = dict(num_experts=moe_experts, top_k=moe_top_k, impl=moe_impl,
               capacity_factor=moe_capacity_factor)
    return [moe if moe_experts > 0 and i % moe_every == moe_every - 1 else None
            for i in range(depth)]


class ViT(CastModel):
    """Patch embed → pre-norm blocks → LN → mean over tokens → head."""

    def __init__(self, num_classes: int = 1000, patch: int = 16, dim: int = 192,
                 depth: int = 12, num_heads: int = 3, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "xla", img_size: int = 224, device=None,
                 moe_experts: int = 0, moe_top_k: int = 2, moe_every: int = 2,
                 moe_impl: str = "partial", moe_capacity_factor: float = 2.0):
        super().__init__()
        if dropout:
            raise ValueError(f"vit dropout={dropout}: the port runs dropout 0 only (every "
                             "shipped config)")
        if img_size % patch:
            raise ValueError(f"image size {img_size} not divisible by patch {patch}")
        self.dtype = dtype
        self.patch_embed = PatchEmbed(dim, patch, dtype, device)
        tokens = (img_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim, device=device))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, dtype, attn_impl, device=device, moe=moe)
            for moe in moe_placement(depth, moe_experts, moe_top_k, moe_every, moe_impl,
                                     moe_capacity_factor))
        self.norm = LayerNorm(dim, dtype, device)
        self.head = Dense(dim, num_classes, device=device)

    def forward(self, x):
        x = self.patch_embed(x.to(self.dtype)) + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x).mean(dim=1)
        hd = head_dtype(x.dtype)
        return self.head(x.to(hd))


@torch.no_grad()
def init_vit(model: ViT, generator: torch.Generator) -> None:
    """Random init from ``generator`` in module order, after the JAX
    model's initializers: the patch conv normal with std sqrt(1/fan_in)
    (flax's lecun normal, untruncated here), ``pos_embed`` and a token
    embedding (the GPT's) normal(0.02), the Linears and the head
    U(±1/sqrt(fan_in)), every bias 0, LayerNorm 1 and 0, a MoE layer's
    gate and ``w_in`` normal with std 1/sqrt(dim), ``w_out`` 1/sqrt(hidden)
    and its biases 0. Every value is written, so the model may be built on
    the meta device."""
    for m in model.modules():
        if isinstance(m, MoeMlp):
            d, f = m.w_in.shape[1:]
            m.gate.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
            m.w_in.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
            m.b_in.zero_()
            m.w_out.normal_(0.0, 1.0 / math.sqrt(f), generator=generator)
            m.b_out.zero_()
        elif isinstance(m, PatchConv):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, CastModel):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)


def _vit(num_classes, *, generator=None, device=None, pipe_stages=0, **kw):
    if pipe_stages and pipe_stages > 1:
        raise not_ported("the pipelined ViT (MESH.PIPE > 1)", PARALLEL)
    with torch.device("meta"):
        model = ViT(num_classes=num_classes, **kw)
    model.to_empty(device=device or "cpu")
    init_vit(model, generator or torch.Generator().manual_seed(0))
    return model


def vit_tiny(num_classes=1000, **kw):
    """ViT-Ti/16: 192 dim, 12 blocks, 3 heads."""
    return _vit(num_classes, **{"dim": 192, "depth": 12, "num_heads": 3, **kw})


def vit_small(num_classes=1000, **kw):
    """ViT-S/16: 384 dim, 12 blocks, 6 heads (22,049,896 parameters at
    1000 classes and 224²)."""
    return _vit(num_classes, **{"dim": 384, "depth": 12, "num_heads": 6, **kw})


def vit_tiny_moe(num_classes=1000, **kw):
    """ViT-Ti/16 with a MoE FFN in every 2nd block (8 experts, top-2 by
    default; ``MODEL.MOE.*``)."""
    return _vit(num_classes, **{"dim": 192, "depth": 12, "num_heads": 3, "moe_experts": 8,
                                **kw})
