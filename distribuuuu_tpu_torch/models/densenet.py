"""DenseNet-121/161/169/201 (counterpart of distribuuuu_tpu/models/densenet.py;
arXiv:1608.06993).

A 7x7/s2 stem → BN → relu → 3x3/s2 max pool, four dense blocks with a
transition (BN → relu → 1x1 conv halving the channels → 2x2 average pool)
between them, a last BN → relu, global average pool and the classifier.
A dense layer is pre-activation, BN → relu → 1x1 conv (``bn_size`` ×
growth) → BN → relu → 3x3 conv (growth), and its output is concatenated to
its input on the channel dim (NHWC, so the concatenation stays channels
last and cuDNN reads every conv's input in its own layout). Published
parameter counts: 7.979M, 28.681M, 14.149M, 20.014M.

Modules carry torchvision's names: ``features.conv0``/``norm0``,
``features.denseblockB.denselayerL.norm1/conv1/norm2/conv2``,
``features.transitionT.norm/conv``, ``features.norm5`` and
``classifier``. Only the stem is a ConvBN (a 7x7, so no conv-epilogue
site); the other convs have no BN after them and are :class:`Conv` units.

``memory_efficient`` recomputes each dense layer in the backward
(``torch.utils.checkpoint`` under ``layers.remat_contexts``: the
recompute reuses the forward's BN shift and leaves the running stats
alone, as JAX's ``nn.remat``); the parameters and the state dict are the
same either way. It defaults to False and no config knob reaches it, as
in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distribuuuu_tpu_torch.models.layers import (
    CNN,
    BatchNorm,
    Conv,
    ConvBN,
    Dense,
    avg_pool_2x2,
    build_on,
    conv2d,
    global_avg_pool,
    head_dtype,
    max_pool_3x3_s2,
    remat_contexts,
)


class DenseLayer(nn.Module):
    """BN → relu → 1x1 (``bn_size``·growth) → BN → relu → 3x3 (growth);
    returns the new features only."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = BatchNorm(in_ch, device=device)
        self.conv1 = conv2d(in_ch, bn_size * growth_rate, 1, device=device)
        self.norm2 = BatchNorm(bn_size * growth_rate, device=device)
        self.conv2 = conv2d(bn_size * growth_rate, growth_rate, 3, device=device)
        self.units = [Conv(self.conv1, dtype), Conv(self.conv2, dtype)]

    def forward(self, x):
        out = self.units[0](F.relu(self.norm1(x, self.dtype)))
        return self.units[1](F.relu(self.norm2(out, self.dtype)))


class Transition(nn.Module):
    """BN → relu → 1x1 conv → 2x2 average pool."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm = BatchNorm(in_ch, device=device)
        self.conv = conv2d(in_ch, out_ch, 1, device=device)
        self.unit = Conv(self.conv, dtype)

    def forward(self, x):
        return avg_pool_2x2(self.unit(F.relu(self.norm(x, self.dtype))))


class DenseNet(CNN):
    """Stem + dense blocks with transitions + BN head, on NHWC input
    ``[B, H, W, 3]``."""

    def __init__(self, growth_rate: int = 32, block_config=(6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4, num_classes: int = 1000,
                 memory_efficient: bool = False, dtype=torch.bfloat16, bn_group: int = 0,
                 s2d_stem: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.bn_group = bn_group  # ghost-BN group size of training (0 = whole batch)
        self.memory_efficient = memory_efficient
        self.features = nn.Module()
        f = self.features
        f.conv0 = nn.Conv2d(3, num_init_features, 7, 2, 3, bias=False, device=device)
        f.norm0 = BatchNorm(num_init_features, device=device)
        self.stem = ConvBN(f.conv0, f.norm0, F.relu, dtype, s2d_stem=s2d_stem)
        ch, self.stages = num_init_features, []
        for i, n_layers in enumerate(block_config):
            block = nn.Module()
            for j in range(n_layers):
                setattr(block, f"denselayer{j + 1}",
                        DenseLayer(ch + j * growth_rate, growth_rate, bn_size, dtype, device))
            setattr(f, f"denseblock{i + 1}", block)
            ch += n_layers * growth_rate
            trans = None
            if i != len(block_config) - 1:
                trans = Transition(ch, ch // 2, dtype, device)
                setattr(f, f"transition{i + 1}", trans)
                ch //= 2
            self.stages.append((list(block.children()), trans))
        f.norm5 = BatchNorm(ch, device=device)
        self.classifier = Dense(ch, num_classes, device=device)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group_size = bn_group

    def conv_units(self):
        """The stem's ConvBN, then every :class:`Conv` unit in order."""
        yield self.stem
        for m in self.modules():
            if isinstance(m, DenseLayer):
                yield from m.units
            elif isinstance(m, Transition):
                yield m.unit

    def forward(self, x):
        x = max_pool_3x3_s2(self.stem(x.to(self.dtype)))
        remat = self.memory_efficient and self.training and torch.is_grad_enabled()
        for layers, trans in self.stages:
            for layer in layers:
                new = (checkpoint(layer, x, use_reentrant=False, context_fn=remat_contexts,
                                  preserve_rng_state=False) if remat else layer(x))
                x = torch.cat([x, new], dim=-1)
            if trans is not None:
                x = trans(x)
        x = global_avg_pool(F.relu(self.features.norm5(x, self.dtype)))
        return self.classifier(x.to(head_dtype(x.dtype)))


def densenet121(num_classes: int = 1000, **kw):
    return build_on(DenseNet, 32, (6, 12, 24, 16), 64, num_classes=num_classes, **kw)


def densenet161(num_classes: int = 1000, **kw):
    return build_on(DenseNet, 48, (6, 12, 36, 24), 96, num_classes=num_classes, **kw)


def densenet169(num_classes: int = 1000, **kw):
    return build_on(DenseNet, 32, (6, 12, 32, 32), 64, num_classes=num_classes, **kw)


def densenet201(num_classes: int = 1000, **kw):
    return build_on(DenseNet, 32, (6, 12, 48, 32), 64, num_classes=num_classes, **kw)
