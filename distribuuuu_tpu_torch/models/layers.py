"""Shared layers of the model zoo (counterpart of distribuuuu_tpu/models/layers.py).

Conventions kept from the JAX package:
  - activations are NHWC tensors throughout. A conv that is not pointwise
    runs ``F.conv2d`` (cuDNN) on the ``permute(0, 3, 1, 2)`` view, which is
    NCHW with channels-last strides, so cuDNN stays channels-last and the
    fused 1x1 kernel reads ``[M, Cin]`` with no copy;
  - parameters are fp32, compute runs in ``DEVICE.COMPUTE_DTYPE``. The
    compute-dtype weights and the folded BN affines are made once, by
    ``prepare()``, when the serving engine is built;
  - eval BatchNorm is the running-stat affine in fp32, cast to the compute
    dtype; at a pointwise site it folds to ``(a, c)`` and rides the fused
    conv epilogue (ops/cuda/conv_epilogue.py).

Training-mode BatchNorm (ghost groups, shifted one-pass variance) belongs
to the training slice and raises here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue


def resolve_dtype(name: str) -> torch.dtype:
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
        "float64": torch.float64,
    }[name]


def head_dtype(dtype: torch.dtype) -> torch.dtype:
    """Classifier-head dtype: fp32 under a low-precision compute dtype,
    promoted to fp64 when the activations already are."""
    return torch.promote_types(torch.float32, dtype)


class BatchNorm(nn.Module):
    """BatchNorm with torch's parameter names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), so a
    torchvision state dict loads as it is. Eval only in this slice."""

    def __init__(self, features: int, eps: float = 1e-5, zero_init: bool = False,
                 device=None):
        super().__init__()
        self.eps = eps
        self.zero_init = zero_init
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def _check_eval(self):
        if self.training:
            raise not_ported("train-mode BatchNorm", "Training slice")

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The eval normalization as fp32 per-channel ``(a, c)`` with
        ``y = x·a + c`` = ``(x − mean)·inv + bias``."""
        self._check_eval()
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Eval BN over the last (channel) dim of an NHWC tensor, in fp32
        (fp64 for fp64 input), cast to ``dtype``."""
        self._check_eval()
        stats_dtype = torch.promote_types(torch.float32, x.dtype)
        inv = (torch.rsqrt(self.running_var + self.eps) * self.weight).to(stats_dtype)
        y = (x.to(stats_dtype) - self.running_mean.to(stats_dtype)) * inv
        return (y + self.bias.to(stats_dtype)).to(dtype)


class ConvBN:
    """Conv (no bias) + BatchNorm + optional activation, the zoo's unit.

    Not a module of its own: it pairs a ``nn.Conv2d`` and a
    :class:`BatchNorm` that the block registers under torchvision's names
    (``conv1``/``bn1``, ``downsample.0``/``downsample.1``). A pointwise,
    stride-1, ungrouped site with a kernel-known activation runs the fused
    conv epilogue; every other site runs ``F.conv2d`` then BN then act.
    """

    def __init__(self, conv: nn.Conv2d, bn: BatchNorm, act=None,
                 dtype: torch.dtype = torch.bfloat16, s2d_stem: bool = False):
        if s2d_stem:
            raise not_ported("DEVICE.S2D_STEM (space-to-depth stem)", "S2D stem")
        self.conv, self.bn, self.act, self.dtype = conv, bn, act, dtype
        pad = [(p, p) for p in conv.padding]
        self.fused, self.reason = conv_epilogue.qualifies(
            conv.kernel_size, conv.stride, pad, conv.groups, act, train=False
        )
        self._cache = None

    def prepare(self) -> None:
        """Cast the weight to the compute dtype (and fold the BN at a fused
        site) once; later forwards read the cache. Call again after the
        weights change."""
        w = self.conv.weight.detach()
        if self.fused:
            o, i = w.shape[:2]
            a, c = (t.detach() for t in self.bn.fold())
            self._cache = (w.reshape(o, i).t().contiguous().to(self.dtype), a, c)
        else:
            self._cache = (w.to(self.dtype).contiguous(memory_format=torch.channels_last),)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn.training:
            raise not_ported("the training forward", "Training slice")
        if self._cache is None:
            self.prepare()
        if self.fused:
            w, a, c = self._cache
            return conv_epilogue.conv1x1_bn_act(
                x.to(self.dtype), w, a, c, conv_epilogue.act_code(self.act),
                out_dtype=self.dtype,
            )
        (w,) = self._cache
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, None,
                     self.conv.stride, self.conv.padding, 1, self.conv.groups)
        y = self.bn(y.permute(0, 2, 3, 1), self.dtype)
        return self.act(y) if self.act is not None else y


def conv2d(in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1,
           device=None) -> nn.Conv2d:
    """A bias-free conv with torch-style symmetric "same" padding."""
    return nn.Conv2d(in_ch, out_ch, k, stride, k // 2, groups=groups, bias=False,
                     device=device)


class Dense(nn.Linear):
    """Linear head computed in the input's dtype (the head dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC global average pooling (mean in the compute dtype)."""
    return x.mean(dim=(1, 2))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1) on NHWC; pads with -inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, in module definition order: convs
    kaiming-normal (fan_out, relu), Linear U(±1/sqrt(fan_in)) with zero
    bias, BN weight 1 (or 0 where zero-initialised), bias 0, stats 0/1.
    Every value is written, so the model may be built on the meta device
    and materialised with ``to_empty`` first."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(0.0 if m.zero_init else 1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
