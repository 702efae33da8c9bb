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
  * ``ring``/``ulysses`` (sequence-sharded) and the MoE and pipelined
    variants are not ported.

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
from distribuuuu_tpu_torch.ops import ring_attention as ra
from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa

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
    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype, self._cache = dtype, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), *self._weights())


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
                 attn_impl: str, device=None, causal: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, device)
        self.attn = Attention(dim, num_heads, dtype, attn_impl, device, causal)
        self.norm2 = LayerNorm(dim, dtype, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, device)

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
        """Cast the Linears' (and the patch conv's) weights to the compute
        dtype once per entry into eval (the serving engines call this at
        build; otherwise the first eval forward does)."""
        for m in self._cast_modules():
            m.prepare()
        return self


class ViT(CastModel):
    """Patch embed → pre-norm blocks → LN → mean over tokens → head."""

    def __init__(self, num_classes: int = 1000, patch: int = 16, dim: int = 192,
                 depth: int = 12, num_heads: int = 3, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "xla", img_size: int = 224, device=None):
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
            Block(dim, num_heads, mlp_ratio, dtype, attn_impl, device=device)
            for _ in range(depth))
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
    U(±1/sqrt(fan_in)), every bias 0, LayerNorm 1 and 0. Every value is
    written, so the model may be built on the meta device."""
    for m in model.modules():
        if isinstance(m, PatchConv):
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


def _vit(num_classes, *, generator=None, device=None, pipe_stages=0, moe_experts=0, **kw):
    if pipe_stages and pipe_stages > 1:
        raise not_ported("the pipelined ViT (MESH.PIPE > 1)", PARALLEL)
    if moe_experts:
        raise not_ported("the MoE ViT (MoE FFN blocks)", PARALLEL)
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
