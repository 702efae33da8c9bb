"""EfficientNet-B0 (counterpart of distribuuuu_tpu/models/efficientnet.py;
arXiv:1905.11946).

A 3x3/s2 stem of 32 channels, sixteen MBConv blocks in seven stages
(``_B0_BLOCKS``), a 1x1 head to 1280 channels, global average pool,
dropout 0.2 and the classifier. MBConv: 1x1 expand (silu; absent at
expansion 1) → depthwise k×k (silu) → squeeze-excite of width
``in_ch // 4`` of the block's input (silu) → 1x1 project (no activation),
plus the input where stride is 1 and the widths match. Every BN has eps
1e-3 and flax momentum 0.99 (torch's 0.01). Published parameter count:
5.289M.

Modules carry timm's ``efficientnet_b0`` names, as the reference reached
this arch through timm: ``conv_stem``/``bn1``, ``blocks.s.i`` with
``conv_pw``/``bn1``, ``conv_dw``/``bn2``, ``se.conv_reduce``/
``se.conv_expand`` and ``conv_pwl``/``bn3`` (block 0, which has no expand:
``conv_dw``/``bn1``, ``se``, ``conv_pw``/``bn2``), ``conv_head``/``bn2``
and ``classifier``.

The expand, project and head 1x1s are ConvBN sites, so in eval they run
the fused conv epilogue (32 a forward, silu or identity). The depthwise
convs are one ``F.conv2d(groups=C)`` whatever ``DISTRIBUUUU_GROUP_CONV``
says: JAX computes them as a plain ``nn.Conv`` and never sends them to
its grouped-conv kernel.
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
    Dropout,
    SqueezeExcite,
    build_on,
    conv2d,
    global_avg_pool,
    head_dtype,
)

# (expand_ratio, channels, repeats, stride, kernel)
_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _bn(features: int, device=None) -> BatchNorm:
    return BatchNorm(features, eps=1e-3, momentum=0.99, device=device)


class MBConv(nn.Module):
    """Inverted residual block (timm's ``InvertedResidual``, or its
    ``DepthwiseSeparableConv`` at expansion 1)."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, stride: int, kernel: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        ch = in_ch * expand_ratio
        units, bn = [], 1
        if expand_ratio != 1:
            self.conv_pw = conv2d(in_ch, ch, 1, device=device)
            self.bn1 = _bn(ch, device)
            units.append(ConvBN(self.conv_pw, self.bn1, F.silu, dtype))
            bn += 1
        self.conv_dw = conv2d(ch, ch, kernel, stride, groups=ch, device=device)
        setattr(self, f"bn{bn}", _bn(ch, device))
        units.append(ConvBN(self.conv_dw, getattr(self, f"bn{bn}"), F.silu, dtype,
                            switch=False))
        self.se = SqueezeExcite(ch, max(1, in_ch // 4), dtype, act=F.silu,
                                names=("conv_reduce", "conv_expand"), device=device)
        proj = "conv_pwl" if expand_ratio != 1 else "conv_pw"
        setattr(self, proj, conv2d(ch, out_ch, 1, device=device))
        setattr(self, f"bn{bn + 1}", _bn(out_ch, device))
        units.append(ConvBN(getattr(self, proj), getattr(self, f"bn{bn + 1}"), None, dtype))
        self.units = units

    def forward(self, x):
        out = x
        for unit in self.units[:-1]:
            out = unit(out)
        out = self.units[-1](self.se(out))
        return out + x if self.residual else out


class EfficientNet(CNN):
    """Stem + MBConv stages + head, on NHWC input ``[B, H, W, 3]``. A
    training forward with dropout needs ``dropout_key`` set (the trainer
    sets it per micro-batch, ``layers.Dropout``)."""

    def __init__(self, blocks=_B0_BLOCKS, stem_ch: int = 32, head_ch: int = 1280,
                 num_classes: int = 1000, dropout_rate: float = 0.2, dtype=torch.bfloat16,
                 bn_group: int = 0, device=None):
        super().__init__()
        self.dtype = dtype
        self.bn_group = bn_group  # ghost-BN group size of training (0 = whole batch)
        self.dropout_key = None
        self.conv_stem = conv2d(3, stem_ch, 3, 2, device=device)
        self.bn1 = _bn(stem_ch, device)
        self.stem = ConvBN(self.conv_stem, self.bn1, F.silu, dtype)
        in_ch, stages = stem_ch, []
        for t, c, n, s, k in blocks:
            stage = []
            for i in range(n):
                stage.append(MBConv(in_ch, c, t, s if i == 0 else 1, k, dtype, device))
                in_ch = c
            stages.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = conv2d(in_ch, head_ch, 1, device=device)
        self.bn2 = _bn(head_ch, device)
        self.head = ConvBN(self.conv_head, self.bn2, F.silu, dtype)
        self.dropout = Dropout(dropout_rate)
        self.classifier = Dense(head_ch, num_classes, device=device)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group_size = bn_group

    def conv_units(self):
        """Every ConvBN of the network: the stem, each block's in order,
        the head."""
        yield self.stem
        for m in self.modules():
            if isinstance(m, MBConv):
                yield from m.units
        yield self.head

    def forward(self, x):
        x = self.blocks(self.stem(x.to(self.dtype)))
        x = self.dropout(global_avg_pool(self.head(x)), self.dropout_key)
        return self.classifier(x.to(head_dtype(x.dtype)))


def efficientnet_b0(num_classes: int = 1000, **kw):
    return build_on(EfficientNet, num_classes=num_classes, **kw)
