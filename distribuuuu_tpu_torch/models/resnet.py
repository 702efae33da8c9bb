"""ResNet family (counterpart of distribuuuu_tpu/models/resnet.py).

BasicBlock (expansion 1), Bottleneck (expansion 4, stride on the 3x3 —
ResNet-V1.5), 7x7/s2 stem + 3x3/s2 max pool, four stages, and the 9
constructors of the JAX package. Submodules and parameters carry
torchvision's names (``conv1``, ``bn1``, ``layer1.0.conv2``,
``downsample.0/1``, ``fc``), so a torchvision-style state dict loads
directly; convs, BNs and the Linear are defined in the flax modules' order.
Activations are NHWC (layers.py). ``model.train()`` reaches every
BatchNorm (batch statistics in ghost groups of ``bn_group``); switching
mode drops the eval weight cache, so an eval after training steps sees the
updated weights. ``remat`` (``TRAIN.REMAT``) runs each block of stages 1-2
under ``torch.utils.checkpoint`` in training, recomputed in the backward
(``layers.remat_contexts`` keeps BatchNorm's shift and running stats as
without it); the parameters and the ``state_dict`` are the same either way.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distribuuuu_tpu_torch.models.layers import (
    CNN,
    BatchNorm,
    ConvBN,
    Dense,
    build_on,
    conv2d,
    global_avg_pool,
    head_dtype,
    max_pool_3x3_s2,
    remat_contexts,
)


class BasicBlock(nn.Module):
    """Two 3x3 convs. expansion = 1."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 zero_init_residual: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv1 = conv2d(in_ch, features, 3, stride, device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv2d(features, features, 3, device=device)
        self.bn2 = BatchNorm(features, zero_init=zero_init_residual, device=device)
        self.downsample = nn.Sequential(
            conv2d(in_ch, features, 1, stride, device=device),
            BatchNorm(features, device=device),
        ) if downsample else None
        self.units = [
            ConvBN(self.conv1, self.bn1, F.relu, dtype),
            ConvBN(self.conv2, self.bn2, None, dtype),
        ]
        self.down = ConvBN(*self.downsample, None, dtype) if downsample else None

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        out = self.units[1](self.units[0](x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 → 3x3(stride) → 1x1, expansion 4; the stride is on the 3x3."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64,
                 zero_init_residual: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        width = int(features * (base_width / 64.0)) * groups
        out_ch = features * self.expansion
        self.conv1 = conv2d(in_ch, width, 1, device=device)
        self.bn1 = BatchNorm(width, device=device)
        self.conv2 = conv2d(width, width, 3, stride, groups, device=device)
        self.bn2 = BatchNorm(width, device=device)
        self.conv3 = conv2d(width, out_ch, 1, device=device)
        self.bn3 = BatchNorm(out_ch, zero_init=zero_init_residual, device=device)
        self.downsample = nn.Sequential(
            conv2d(in_ch, out_ch, 1, stride, device=device),
            BatchNorm(out_ch, device=device),
        ) if downsample else None
        self.units = [
            ConvBN(self.conv1, self.bn1, F.relu, dtype),
            ConvBN(self.conv2, self.bn2, F.relu, dtype),
            ConvBN(self.conv3, self.bn3, None, dtype),
        ]
        self.down = ConvBN(*self.downsample, None, dtype) if downsample else None

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        out = x
        for unit in self.units:
            out = unit(out)
        return F.relu(out + identity)


class ResNet(CNN):
    """Stem + 4 stages + head, on NHWC input ``[B, H, W, 3]``."""

    stage_features = (64, 128, 256, 512)

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 groups: int = 1, width_per_group: int = 64,
                 zero_init_residual: bool = False, dtype=torch.bfloat16,
                 bn_group: int = 0, s2d_stem: bool = False, remat: bool = False,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.bn_group = bn_group  # ghost-BN group size of training (0 = whole batch)
        self.remat = remat  # recompute stages 1-2 in the backward
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = BatchNorm(64, device=device)
        self.stem = ConvBN(self.conv1, self.bn1, F.relu, dtype, s2d_stem=s2d_stem)
        in_ch = 64
        for stage, (feats, n_blocks) in enumerate(zip(self.stage_features, layers)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                needs_down = s != 1 or in_ch != feats * block.expansion
                blocks.append(block(
                    in_ch, feats, s, needs_down and i == 0, groups,
                    width_per_group, zero_init_residual, dtype, device,
                ))
                in_ch = feats * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = Dense(in_ch, num_classes, device=device)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group_size = bn_group

    def conv_units(self):
        """Every ConvBN of the network, stem first."""
        yield self.stem
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                yield from m.units
                if m.down is not None:
                    yield m.down

    def forward(self, x):
        x = max_pool_3x3_s2(self.stem(x.to(self.dtype)))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, stage in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            if remat and i < 2:
                for block in stage:
                    x = checkpoint(block, x, use_reentrant=False, context_fn=remat_contexts,
                                   preserve_rng_state=False)
            else:
                x = stage(x)
        x = global_avg_pool(x)
        hd = head_dtype(x.dtype)
        return self.fc(x.to(hd))


def _resnet(block, layers, num_classes=1000, **kw):
    return build_on(ResNet, block, layers, num_classes, **kw)


def resnet18(num_classes=1000, **kw):
    return _resnet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return _resnet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 8, 36, 3], num_classes, **kw)


def resnext50_32x4d(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, groups=32, width_per_group=4, **kw)


def resnext101_32x8d(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 23, 3], num_classes, groups=32, width_per_group=8, **kw)


def wide_resnet50_2(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 6, 3], num_classes, width_per_group=128, **kw)


def wide_resnet101_2(num_classes=1000, **kw):
    return _resnet(Bottleneck, [3, 4, 23, 3], num_classes, width_per_group=128, **kw)
