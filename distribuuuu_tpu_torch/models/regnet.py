"""RegNet-X/Y (counterpart of distribuuuu_tpu/models/regnet.py).

arXiv:2003.13678's quantized-linear widths (``generate_widths``,
``adjust_groups``, the port's own copies): a 3x3/s2 stem of 32 channels
with relu and no max pool, four stages of bottleneck-1 blocks (1x1 → 3x3
grouped, the stride on a stage's first block → SE for the Y models, its
width ``round(0.25·in_w)`` of the block's INPUT width → 1x1 with a
zero-initialised BN, plus the shortcut, relu), global average pool and a
head in fp32. Published parameter counts: regnetx_160 54.279M,
regnety_160 83.590M, regnety_320 145.047M.

Modules and parameters carry timm's names, as the reference reached these
archs through timm: ``stem.conv/bn``, ``s1 … s4`` with blocks ``b1 …``,
each with ``conv1/conv2/conv3`` (``.conv``, ``.bn``), ``se.fc1/fc2`` and
``downsample.conv/bn``, and ``head.fc``. They are defined in the flax
modules' order: a block's downsample first. Every grouped 3x3 is a
``ConvBN`` site, so ``DISTRIBUUUU_GROUP_CONV=pallas`` sends the stride-1
ones at ≤ 14² (stage 3 at 224²) to the grouped-conv kernel.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch.models.layers import (
    CNN,
    BatchNorm,
    ConvBN,
    Dense,
    SqueezeExcite,
    build_on,
    conv2d,
    global_avg_pool,
    head_dtype,
)


def generate_widths(w_a: float, w_0: int, w_m: float, depth: int, q: int = 8):
    """Quantized-linear per-block widths → per-stage (width, depth) lists."""
    ws_cont = np.arange(depth) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws = w_0 * np.power(w_m, ks)
    ws = (np.round(ws / q) * q).astype(int)
    stage_ws, stage_ds = np.unique(ws, return_counts=True)  # sorted ascending
    return stage_ws.tolist(), stage_ds.tolist()


def adjust_groups(widths, group_w: int):
    """Clamp group width to the block width and round widths to multiples."""
    gs = [min(group_w, w) for w in widths]
    ws = [int(round(w / g) * g) for w, g in zip(widths, gs)]
    return ws, gs


class ConvNormAct(nn.Module):
    """A ``conv`` and its ``bn`` (timm's names) run as one ConvBN unit."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1,
                 act=None, zero_init: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, k, stride, groups, device=device)
        self.bn = BatchNorm(out_ch, zero_init=zero_init, device=device)
        self.unit = ConvBN(self.conv, self.bn, act, dtype)

    def forward(self, x):
        return self.unit(x)


class RegNetBlock(nn.Module):
    """X/Y bottleneck block, bottleneck ratio 1."""

    def __init__(self, in_w: int, width: int, stride: int, group_width: int, se_width: int,
                 downsample: bool, dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.downsample = ConvNormAct(in_w, width, 1, stride, **kw) if downsample else None
        self.conv1 = ConvNormAct(in_w, width, 1, act=F.relu, **kw)
        self.conv2 = ConvNormAct(width, width, 3, stride, width // group_width, F.relu, **kw)
        self.se = SqueezeExcite(width, se_width, **kw) if se_width else None
        self.conv3 = ConvNormAct(width, width, 1, zero_init=True, **kw)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        if self.se is not None:
            out = self.se(out)
        return F.relu(self.conv3(out) + shortcut)


class _Head(nn.Module):
    def __init__(self, in_w: int, num_classes: int, device=None):
        super().__init__()
        self.fc = Dense(in_w, num_classes, device=device)


class RegNet(CNN):
    """Stem + stages + head, on NHWC input ``[B, H, W, 3]``."""

    def __init__(self, w_a: float, w_0: int, w_m: float, depth: int, group_w: int,
                 se_ratio: float = 0.0, num_classes: int = 1000, stem_w: int = 32,
                 dtype=torch.bfloat16, bn_group: int = 0, device=None):
        super().__init__()
        self.dtype = dtype
        self.bn_group = bn_group  # ghost-BN group size of training (0 = whole batch)
        self.stem = ConvNormAct(3, stem_w, 3, 2, act=F.relu, dtype=dtype, device=device)
        widths, depths = generate_widths(w_a, w_0, w_m, depth)
        widths, groups = adjust_groups(widths, group_w)
        in_w = stem_w
        self.stages = []
        for s, (w, d, g) in enumerate(zip(widths, depths, groups)):
            blocks = OrderedDict()
            for i in range(d):
                se_w = int(round(in_w * se_ratio)) if se_ratio else 0
                blocks[f"b{i + 1}"] = RegNetBlock(in_w, w, 2 if i == 0 else 1, g, se_w,
                                                  i == 0, dtype, device)
                in_w = w
            stage = nn.Sequential(blocks)
            setattr(self, f"s{s + 1}", stage)
            self.stages.append(stage)
        self.head = _Head(in_w, num_classes, device)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group_size = bn_group

    def conv_units(self):
        """Every ConvBN of the network, stem first, each block's downsample
        before its conv1..conv3."""
        for m in self.modules():
            if isinstance(m, ConvNormAct):
                yield m.unit

    def forward(self, x):
        x = self.stem(x.to(self.dtype))
        for stage in self.stages:
            x = stage(x)
        x = global_avg_pool(x)
        return self.head.fc(x.to(head_dtype(x.dtype)))


def _regnet(num_classes=1000, **kw):
    return build_on(RegNet, num_classes=num_classes, **kw)


def regnetx_160(num_classes=1000, **kw):
    """RegNetX-16GF (timm's regnetx_160)."""
    return _regnet(num_classes, w_a=55.59, w_0=216, w_m=2.1, depth=22, group_w=128, **kw)


def regnety_160(num_classes=1000, **kw):
    """RegNetY-16GF (timm's regnety_160)."""
    return _regnet(num_classes, w_a=106.23, w_0=200, w_m=2.48, depth=18, group_w=112,
                   se_ratio=0.25, **kw)


def regnety_320(num_classes=1000, **kw):
    """RegNetY-32GF (timm's regnety_320)."""
    return _regnet(num_classes, w_a=115.89, w_0=232, w_m=2.53, depth=20, group_w=232,
                   se_ratio=0.25, **kw)
