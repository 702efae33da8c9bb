"""BoTNet-50, the Bottleneck Transformer (counterpart of
distribuuuu_tpu/models/botnet.py; arXiv:2101.11605).

ResNet-50's stem and stages 1-3 (the port's ``resnet.Bottleneck``, under
torchvision's names ``conv1``, ``bn1``, ``layer1`` … ``layer3``), then a
stack of three MHSA bottlenecks (``layer4.0`` … ``layer4.2``: heads 4,
q/k/v widths 128, projection factor 4, relative position logits over the
``fmap_size`` grid, 14² at 224²), global average pool and ``fc``. Each
stack block has torchvision's bottleneck names with the 3x3 conv replaced
by the attention: ``conv1``/``bn1`` (1x1 reduce, relu), ``mhsa``
(``to_qk``, ``to_v``, ``rel_height``, ``rel_width``), ``bn2`` (relu),
``conv3``/``bn3`` (1x1, zero-initialised scale) and, in block 0,
``downsample.0``/``downsample.1``. Published parameter count: 20.859M.

The reference's quirks are kept: the stack's shortcut conv has a ReLU
after its BN (unlike ResNet's), the stack runs at stride 1 (an average
pool would follow the attention only at stride 2), the position logits
are taken in fp32 on the *scaled* q, and a grid other than ``fmap_size``
fails. The attention is ``ops/attention.mhsa_2d``, plain PyTorch
(``attn_impl`` is ``auto`` or ``xla``, as in JAX, where the fused kernel
was retired). In eval the 1x1 ConvBNs run the fused conv epilogue: 27 in
the trunk and 7 in the stack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    CNN,
    BatchNorm,
    ConvBN,
    Dense,
    avg_pool_2x2,
    build_on,
    conv2d,
    global_avg_pool,
    head_dtype,
    max_pool_3x3_s2,
)
from distribuuuu_tpu_torch.models.resnet import Bottleneck
from distribuuuu_tpu_torch.ops import attention as att_ops


class MHSA2D(nn.Module):
    """Multi-head self-attention over an H×W NHWC feature map. q and k
    come from one 1x1 conv (``to_qk``, lecun-normal init), v from another
    (``to_v``); both in the compute dtype, with an eval cache of their
    compute-dtype weights (``prepare()``)."""

    def __init__(self, dim: int, fmap_size, heads: int = 4, dim_qk: int = 128,
                 dim_v: int = 128, rel_pos_emb: bool = True, attn_impl: str = "auto",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if attn_impl not in ("auto", "xla"):
            raise ValueError(
                f"attn_impl={attn_impl!r}: botnet accepts 'auto'/'xla' (the attention "
                "is plain einsums; the JAX package retired its fused kernel for this grid)")
        self.fmap_size = tuple(fmap_size)
        self.heads, self.dim_qk, self.dim_v = heads, dim_qk, dim_v
        self.rel_pos_emb, self.dtype = rel_pos_emb, dtype
        self.to_qk = nn.Conv2d(dim, heads * dim_qk * 2, 1, bias=False, device=device)
        self.to_v = nn.Conv2d(dim, heads * dim_v, 1, bias=False, device=device)
        self.to_qk.lecun_init = self.to_v.lecun_init = True
        h, w = self.fmap_size
        if rel_pos_emb:
            self.rel_height = nn.Parameter(torch.empty(2 * h - 1, dim_qk, device=device))
            self.rel_width = nn.Parameter(torch.empty(2 * w - 1, dim_qk, device=device))
        else:
            self.emb_height = nn.Parameter(torch.empty(h, dim_qk, device=device))
            self.emb_width = nn.Parameter(torch.empty(w, dim_qk, device=device))
        self._cache = None

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The position tables: normal with std ``dim_qk ** -0.5``."""
        for p in (self.rel_height, self.rel_width) if self.rel_pos_emb else (
                self.emb_height, self.emb_width):
            p.normal_(0.0, self.dim_qk ** -0.5, generator=generator)

    def _weights(self):
        return [c.weight.reshape(c.weight.shape[0], -1).to(self.dtype)
                for c in (self.to_qk, self.to_v)]

    def prepare(self) -> None:
        with torch.no_grad():
            self._cache = self._weights()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if (h, w) != self.fmap_size:
            raise AssertionError(f"MHSA grid mismatch: got {(h, w)}, built for "
                                 f"{self.fmap_size}")
        if self.training:
            w_qk, w_v = self._weights()
        else:
            if self._cache is None:
                self.prepare()
            w_qk, w_v = self._cache
        n, dqk, dv = self.heads, self.dim_qk, self.dim_v
        x = x.to(self.dtype)
        q, k = F.linear(x, w_qk).chunk(2, dim=-1)

        def to_heads(t, d):
            return t.reshape(b, h * w, n, d).transpose(1, 2)

        q, k, v = to_heads(q, dqk), to_heads(k, dqk), to_heads(F.linear(x, w_v), dv)
        scale = dqk ** -0.5
        qs = (q * scale).float()  # fp32 whatever the compute dtype, as in JAX
        if self.rel_pos_emb:
            pos = att_ops.rel_pos_logits(qs, self.rel_height.float(), self.rel_width.float(),
                                         h, w)
        else:
            pos = att_ops.abs_pos_logits(qs, self.emb_height.float(), self.emb_width.float())
        out = att_ops.mhsa_2d(q, k, v, pos, scale)
        return out.transpose(1, 2).reshape(b, h, w, n * dv)


class BoTBlock(nn.Module):
    """A bottleneck with MHSA in place of the 3x3 conv."""

    def __init__(self, in_ch: int, fmap_size, dim_out: int = 2048, stride: int = 1,
                 heads: int = 4, proj_factor: int = 4, dim_qk: int = 128, dim_v: int = 128,
                 rel_pos_emb: bool = True, downsample: bool = False,
                 attn_impl: str = "auto", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.stride = stride
        # created first, as flax numbers the shortcut ConvBN_0
        self.downsample = nn.Sequential(
            conv2d(in_ch, dim_out, 1, stride, device=device),
            BatchNorm(dim_out, device=device),
        ) if downsample else None
        width = dim_out // proj_factor
        self.conv1 = conv2d(in_ch, width, 1, device=device)
        self.bn1 = BatchNorm(width, device=device)
        self.mhsa = MHSA2D(width, fmap_size, heads, dim_qk, dim_v, rel_pos_emb, attn_impl,
                           dtype, device)
        self.bn2 = BatchNorm(heads * dim_v, device=device)
        self.conv3 = conv2d(heads * dim_v, dim_out, 1, device=device)
        self.bn3 = BatchNorm(dim_out, zero_init=True, device=device)
        self.dtype = dtype
        # the reference's shortcut is conv → BN → ReLU
        self.down = ConvBN(*self.downsample, F.relu, dtype) if downsample else None
        self.units = [ConvBN(self.conv1, self.bn1, F.relu, dtype),
                      ConvBN(self.conv3, self.bn3, None, dtype)]

    def forward(self, x):
        shortcut = x if self.down is None else self.down(x)
        out = self.mhsa(self.units[0](x))
        if self.stride == 2:
            out = avg_pool_2x2(out)
        out = F.relu(self.bn2(out, self.dtype))
        return F.relu(self.units[1](out) + shortcut)


class BoTNet50(CNN):
    """ResNet-50 stem and stages 1-3, then the 3-block stack, on NHWC
    input ``[B, H, W, 3]`` with H/16 × W/16 = ``fmap_size``."""

    def __init__(self, num_classes: int = 1000, fmap_size=(14, 14), attn_impl: str = "auto",
                 dtype=torch.bfloat16, bn_group: int = 0, s2d_stem: bool = False,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.bn_group = bn_group  # ghost-BN group size of training (0 = whole batch)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm(64, device=device)
        self.stem = ConvBN(self.conv1, self.bn1, F.relu, dtype, s2d_stem=s2d_stem)
        in_ch = 64
        for stage, (feats, n_blocks) in enumerate(zip((64, 128, 256), (3, 4, 6))):
            blocks = []
            for i in range(n_blocks):
                s = (1 if stage == 0 else 2) if i == 0 else 1
                blocks.append(Bottleneck(in_ch, feats, s, i == 0, dtype=dtype, device=device))
                in_ch = feats * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.layer4 = nn.Sequential(*[
            BoTBlock(in_ch if i == 0 else 2048, fmap_size, 2048, 1, downsample=i == 0,
                     attn_impl=attn_impl, dtype=dtype, device=device) for i in range(3)])
        self.fc = Dense(2048, num_classes, device=device)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group_size = bn_group

    def conv_units(self):
        """Every ConvBN of the network, stem first."""
        yield self.stem
        for m in self.modules():
            if isinstance(m, (Bottleneck, BoTBlock)):
                yield from m.units
                if m.down is not None:
                    yield m.down

    def forward(self, x):
        x = max_pool_3x3_s2(self.stem(x.to(self.dtype)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = global_avg_pool(x)
        return self.fc(x.to(head_dtype(x.dtype)))


def botnet50(num_classes: int = 1000, fmap_size=(14, 14), **kw):
    """BoTNet-50 for 224² input (``fmap_size`` = input/16)."""
    return build_on(BoTNet50, num_classes, tuple(fmap_size), **kw)
