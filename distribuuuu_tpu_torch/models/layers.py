"""Shared layers of the model zoo (counterpart of distribuuuu_tpu/models/layers.py).

Conventions kept from the JAX package:
  - activations are NHWC tensors throughout. A conv that is not pointwise
    runs ``F.conv2d`` (cuDNN) on the ``permute(0, 3, 1, 2)`` view, which is
    NCHW with channels-last strides, so cuDNN stays channels-last and the
    fused 1x1 kernel reads ``[M, Cin]`` with no copy;
  - parameters are fp32 masters, compute runs in ``DEVICE.COMPUTE_DTYPE``
    with explicit casts (the JAX dtype policy, not ``torch.autocast``):
    convs in the compute dtype, BN statistics in fp32, the head in fp32;
  - in eval the compute-dtype weights and the folded BN affines are made
    once per entry into eval (``prepare()``, or lazily at the first
    forward); eval BatchNorm is the running-stat affine in fp32, cast to
    the compute dtype, and at a pointwise site it folds to ``(a, c)`` and
    rides the fused conv epilogue (ops/cuda/conv_epilogue.py);
  - in training every forward casts the fp32 weight (a differentiable
    cast, so the gradient reaches the master) and runs conv → batch-stat
    BN → act unfused, as ``conv_epilogue.qualifies(train=True)`` decides;
  - a grouped conv is routed by ``DISTRIBUUUU_GROUP_CONV``, the JAX
    package's switch (``group_conv_mode``), in training and in eval,
    except a depthwise conv that JAX computes as a plain ``nn.Conv``
    (EfficientNet's), which opts out (``ConvBN(..., switch=False)``);
  - dropout draws its mask on the host from an explicit generator
    (:class:`Dropout`), so a run draws the same masks at any world size.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distribuuuu_tpu_torch import graphs, not_ported
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue, group_conv
from distribuuuu_tpu_torch.parallel import dist, tp

GROUP_CONV_MODES = ("auto", "unrolled", "fused", "blockdiag", "pallas")

# the phase of a rematerialized block this thread is in: None, "forward"
# or "recompute" (remat_contexts)
_remat = threading.local()


@contextlib.contextmanager
def _remat_phase(phase: str):
    prev = getattr(_remat, "phase", None)
    _remat.phase = phase
    try:
        yield
    finally:
        _remat.phase = prev


def remat_contexts():
    """``context_fn`` of ``torch.utils.checkpoint`` for a rematerialized
    block: its forward runs in the "forward" phase, where each
    :class:`BatchNorm` stashes the shift it used; the backward's recompute
    in the "recompute" phase, where it reuses that shift and leaves the
    running stats alone. So the recompute computes what the forward did,
    and the stats move once a forward, as under JAX's ``nn.remat``."""
    return _remat_phase("forward"), _remat_phase("recompute")


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
    torchvision state dict loads as it is.

    Training computes the batch statistics as ``_BNCore`` of the JAX
    package does (distribuuuu_tpu/models/layers.py):

    * ghost groups of ``group_size`` samples (0 = the whole batch) over
      the GLOBAL batch, every process's batch in rank order: a global
      batch of ``N <= group_size`` is one group, an indivisible one
      raises. Under a process group (``parallel/dist.py``) a group inside
      a process's batch is computed there; a group of k whole per-process
      batches (the whole global batch included: SyncBN) all-reduces its
      sums over those k ranks, with a gradient; a group that would cut a
      process's batch is refused;
    * statistics in fp32, promoted to f64 on f64 input;
    * the one-pass shifted variance ``E[d²] − E[d]²`` with ``d = x − m̂``
      and the running mean as the constant shift ``m̂``, clamped at 0;
      ``DISTRIBUUUU_BN_VARIANCE`` = ``centered`` (two-pass) or
      ``uncentered`` (shift 0) selects the other formulations;
    * the running variance is the mean of the per-group UNBIASED
      variances over every group of the global batch (averaged across
      processes, so the running stats stay replicated); running stats
      move as ``m·ra + (1−m)·upd`` with flax's m = 0.9
      (``DISTRIBUUUU_BN_MOMENTUM`` overrides), stored in their own dtype;
    * inside a rematerialized block (``remat_contexts``) the backward's
      recompute reuses the forward's shift and does not move the running
      stats again; a group that all-reduces its sums does so again in
      the recompute, on every process in the same order.
    """

    def __init__(self, features: int, eps: float = 1e-5, zero_init: bool = False,
                 group_size: int = 0, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # flax's decay of the running stats
        self.zero_init = zero_init
        self.group_size = group_size
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The eval normalization as fp32 per-channel ``(a, c)`` with
        ``y = x·a + c`` = ``(x − mean)·inv + bias``."""
        if self.training:
            raise ValueError("BatchNorm.fold is the eval path; batch statistics "
                             "cannot be folded into an affine")
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """BN over the last (channel) dim of an NHWC tensor, in fp32 (fp64
        for fp64 input), cast to ``dtype``: batch statistics in training,
        the running-stat affine in eval."""
        stats_dtype = torch.promote_types(torch.float32, x.dtype)
        if self.training:
            return self._train(x.to(stats_dtype)).to(dtype)
        inv = (torch.rsqrt(self.running_var + self.eps) * self.weight).to(stats_dtype)
        y = (x.to(stats_dtype) - self.running_mean.to(stats_dtype)) * inv
        return (y + self.bias.to(stats_dtype)).to(dtype)

    def _moments(self, v: torch.Tensor, dims, group=None, span: int = 1):
        """(mean, biased var) of ``v`` over ``dims``, by the formulation
        ``DISTRIBUUUU_BN_VARIANCE`` names. With ``group`` the samples of
        ``span`` processes (equal counts) make one group: the local means
        are summed over them in one collective, with a gradient, and
        divided by ``span``."""
        mode = os.environ.get("DISTRIBUUUU_BN_VARIANCE", "shifted")
        if mode not in ("shifted", "centered", "uncentered"):
            raise ValueError(f"DISTRIBUUUU_BN_VARIANCE={mode!r}")

        def means(*ts):
            ms = [t.mean(dims, keepdim=True) for t in ts]
            if group is None:
                return ms
            return (dist.synced_sum(torch.stack(ms), group) / span).unbind(0)

        if mode == "centered":
            (m,) = means(v)
            (var,) = means(torch.square(v - m))
            return m.squeeze(dims), var.squeeze(dims)
        shift = self._shift() if mode == "shifted" else 0.0
        d = v - shift
        s1, s2 = (t.squeeze(dims) for t in means(d, torch.square(d)))
        return s1 + shift, clamp0(s2 - torch.square(s1))

    def _shift(self) -> torch.Tensor:
        """The running mean as the variance's constant shift: its value
        before this forward's update, the same in a remat recompute."""
        phase = getattr(_remat, "phase", None)
        if phase == "recompute":
            return self._remat_shift
        shift = self.running_mean.detach()
        if phase == "forward":
            shift = self._remat_shift = shift.clone()
        return shift

    def _train(self, xf: torch.Tensor) -> torch.Tensor:
        n, feat, gs = xf.shape[0], xf.shape[-1], self.group_size
        spatial = math.prod(xf.shape[1:-1])
        world = dist.get_world_size()
        total = n * world  # the global batch, as JAX groups it
        if gs > 0 and total > gs:
            if total % gs:
                raise ValueError(
                    f"ghost BN group_size={gs} does not divide batch {total}; "
                    "set MODEL.BN_GROUP to a divisor of the batch"
                )
            if n % gs and gs % n:
                raise not_ported(f"ghost BN groups of {gs} over per-process batches of "
                                 f"{n} (a group that cuts a process's batch)",
                                 "Real data and many processes")
        if gs > 0 and n > gs:
            xg = xf.reshape(n // gs, gs, *xf.shape[1:])
            dims = tuple(range(1, xg.dim() - 1))
            bshape = (n // gs,) + (1,) * (xg.dim() - 2) + (feat,)
            gmean, gvar = self._moments(xg, dims)  # (groups, C)
            inv = torch.rsqrt(gvar + self.eps).reshape(bshape) * self.weight
            y = ((xg - gmean.reshape(bshape)) * inv + self.bias).reshape(xf.shape)
            count = gs * spatial
            mean_upd, var_upd = gmean.mean(0), gvar.mean(0) * count / max(count - 1, 1)
        else:
            # one group: this batch, k whole per-process batches, or the
            # global batch (SyncBN); a process group runs SyncBN's
            # collective even at one process
            span = world if gs == 0 or gs >= total else gs // n
            synced = dist.is_initialized() and (span > 1 or gs == 0)
            mean, var = self._moments(xf, tuple(range(xf.dim() - 1)),
                                      dist.rank_group(span) if synced else None, span)
            y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
            count = n * span * spatial
            mean_upd, var_upd = mean, var * count / max(count - 1, 1)
        if getattr(_remat, "phase", None) == "recompute":
            return y
        m = float(os.environ.get("DISTRIBUUUU_BN_MOMENTUM", self.momentum))
        with torch.no_grad():
            upd = [mean_upd.detach(), var_upd.detach()]
            if world > 1:  # the mean over every group of the global batch
                upd = dist.scaled_all_reduce(upd)
            for buf, u in zip((self.running_mean, self.running_var), upd):
                buf.copy_((m * buf + (1.0 - m) * u).to(buf.dtype))
        return y


def clamp0(v: torch.Tensor) -> torch.Tensor:
    """``max(v, 0)`` with ``jnp.maximum``'s gradient at a tie: half of it
    (``torch.maximum``'s too), where ``clamp_min`` passes all of it. A
    variance lands exactly on 0 when a ghost group's values are equal."""
    return torch.maximum(v, v.new_zeros(()))


def group_conv_mode() -> str:
    """How grouped convs compute, from ``DISTRIBUUUU_GROUP_CONV`` (the JAX
    package's switch, same values and meaning; ``ConvBN`` reads it when the
    model is built):

    * ``auto`` (default), ``unrolled``, ``fused``: one ``F.conv2d(...,
      groups=G)`` (JAX's per-group slicing and ``feature_group_count`` are
      the same grouped conv; the slicing was a TPU retiling workaround);
    * ``blockdiag``: one dense conv over the block-diagonal weight;
    * ``pallas``: the grouped-conv kernel (``ops/cuda/group_conv``) at every
      site ``group_conv.qualifies`` admits, ``F.conv2d`` elsewhere.

    Any other value raises ``ValueError``, as in JAX."""
    mode = os.environ.get("DISTRIBUUUU_GROUP_CONV", "auto")
    if mode not in GROUP_CONV_MODES:
        raise ValueError(f"DISTRIBUUUU_GROUP_CONV={mode!r}: one of {list(GROUP_CONV_MODES)}")
    return mode


def block_diagonal(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The dense ``[G·fg, G·cg, kh, kw]`` weight whose diagonal blocks are
    the grouped weight's and whose other blocks are 0 (differentiable; the
    zero blocks take no gradient to the grouped weight)."""
    c_out, cg, kh, kw = w.shape
    fg = c_out // groups
    eye = torch.eye(groups, dtype=w.dtype, device=w.device)
    dense = torch.einsum("gfchw,gk->gfkchw", w.reshape(groups, fg, cg, kh, kw), eye)
    return dense.reshape(c_out, groups * cg, kh, kw).contiguous(
        memory_format=torch.channels_last)


class ConvBN:
    """Conv (no bias) + BatchNorm + optional activation, the zoo's unit.

    Not a module of its own: it pairs a ``nn.Conv2d`` and a
    :class:`BatchNorm` that the block registers under torchvision's names
    (``conv1``/``bn1``, ``downsample.0``/``downsample.1``) or timm's
    (``conv1.conv``/``conv1.bn``). In eval a pointwise, stride-1,
    ungrouped site with a kernel-known activation runs the fused conv
    epilogue; every other site, and every site in training (the BN's mode
    decides), runs the conv then BN then act. A grouped conv computes as
    ``group_conv_mode()`` says, read here at build: under ``pallas`` a site
    that ``group_conv.qualifies`` for its input's H and W runs
    ``group_conv.group_conv3x3`` (the kernel on the card, in the forward
    and the backward's dx). ``switch=False`` takes a grouped conv out of
    the switch: it is one ``F.conv2d(groups=G)`` whatever the variable
    says, as JAX's plain ``nn.Conv`` sites are (EfficientNet's depthwise
    convs).
    """

    def __init__(self, conv: nn.Conv2d, bn: BatchNorm, act=None,
                 dtype: torch.dtype = torch.bfloat16, s2d_stem: bool = False,
                 switch: bool = True):
        if s2d_stem:
            raise not_ported("DEVICE.S2D_STEM (space-to-depth stem)", "S2D stem")
        self.conv, self.bn, self.act, self.dtype = conv, bn, act, dtype
        self.pad = [(p, p) for p in conv.padding]
        self.fused, self.reason = conv_epilogue.qualifies(
            conv.kernel_size, conv.stride, self.pad, conv.groups, act, train=False
        )
        self.group_mode = group_conv_mode() if conv.groups > 1 and switch else None
        self._cache = None

    def prepare(self) -> None:
        """Cast the weight to the compute dtype (and fold the BN at a fused
        site) once; later eval forwards read the cache. The model drops the
        cache whenever it changes mode (``ResNet.train``), so an eval after
        training steps rebuilds it from the updated weights."""
        w = self.conv.weight.detach()
        if self.fused:
            o, i = w.shape[:2]
            a, c = (t.detach() for t in self.bn.fold())
            self._cache = (w.reshape(o, i).t().contiguous().to(self.dtype), a, c)
        else:
            self._cache = (w.to(self.dtype).contiguous(memory_format=torch.channels_last),)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn.training:
            w = self.conv.weight.to(self.dtype, memory_format=torch.channels_last)
            return self._conv_bn_act(x, w)
        if self._cache is None:
            self.prepare()
        if not self.fused:  # the site's shape runs the plain layer
            kernel_tier.note_select("conv_epilogue", "plain")
        if self.fused:
            w, a, c = self._cache
            return conv_epilogue.conv1x1_bn_act(
                x.to(self.dtype), w, a, c, conv_epilogue.act_code(self.act),
                out_dtype=self.dtype,
            )
        return self._conv_bn_act(x, self._cache[0])

    def group_kernel(self, h: int, w: int) -> bool:
        """Whether this site runs the grouped-conv kernel on an H x W input."""
        c = self.conv
        return self.group_mode == "pallas" and group_conv.qualifies(
            c.kernel_size, c.stride, self.pad, h, w)[0]

    def _conv_bn_act(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, c, groups = x.to(self.dtype), self.conv, self.conv.groups
        if self.group_kernel(x.shape[1], x.shape[2]):
            y = group_conv.group_conv3x3(x, w, 1, groups)
        else:
            if self.group_mode == "blockdiag":
                w, groups = block_diagonal(w, groups), 1
            y = F.conv2d(x.permute(0, 3, 1, 2), w, None, c.stride, c.padding, 1,
                         groups).permute(0, 2, 3, 1)
        y = self.bn(y, self.dtype)
        return self.act(y) if self.act is not None else y


def conv2d(in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1,
           device=None) -> nn.Conv2d:
    """A bias-free conv with torch-style symmetric "same" padding."""
    return nn.Conv2d(in_ch, out_ch, k, stride, k // 2, groups=groups, bias=False,
                     device=device)


class Conv:
    """A conv with no BatchNorm after it (DenseNet's pre-activation convs,
    BN → relu → conv): ``F.conv2d`` on the channels-last view in the
    compute dtype. Like :class:`ConvBN` it pairs with a registered
    ``nn.Conv2d`` and keeps an eval cache of the compute-dtype weight
    (``prepare()``), which the model drops on every mode change; in
    training each forward casts the fp32 master (the mode is the conv's)."""

    fused = False  # never a conv-epilogue site: no BN to fold

    def __init__(self, conv: nn.Conv2d, dtype: torch.dtype = torch.bfloat16):
        self.conv, self.dtype = conv, dtype
        self._cache = None

    def prepare(self) -> None:
        self._cache = self.conv.weight.detach().to(
            self.dtype, memory_format=torch.channels_last)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if c.training:
            w = c.weight.to(self.dtype, memory_format=torch.channels_last)
        else:
            if self._cache is None:
                self.prepare()
            w = self._cache
        return F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, None, c.stride, c.padding,
                        1, c.groups).permute(0, 2, 3, 1)


class Dropout(nn.Module):
    """flax ``nn.Dropout``'s semantics on a ``[B, ...]`` tensor: in
    training keep each element with probability 1 − rate and scale the
    kept ones by 1/(1 − rate) (in the input's dtype), identity in eval.

    The mask is drawn on the host (:meth:`draw`) by a ``torch.Generator``
    seeded from ``key`` = ``(RNG_SEED, step, micro-batch)`` only (through
    numpy's ``SeedSequence``), for the GLOBAL batch (this process's batch
    times the world size), of which each process takes its own rows. A
    run so draws the same masks at any world size, on the card and on the
    CPU, and after a resume, as JAX's ``fold_in(key, step)`` then
    ``fold_in(step_key, micro)`` does. The bits are not JAX's: a torch
    Generator is not threefry, so a mask equals JAX's only in
    distribution.

    ``key`` is either that tuple (the mask is drawn here and copied to the
    device from pinned memory) or a :class:`DropoutSlot`, whose masks lie
    in static device buffers that the trainer refills before each call of
    a captured step (``trainer.TrainStep``): a graph reads the slot's
    buffer, never a copy made while it was captured."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1)")
        self.rate = rate

    def draw(self, key, shape) -> torch.Tensor:
        """The keep mask (CPU bool) of this process's ``shape[0]`` rows
        under ``key``."""
        seed = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        n, world, rank = shape[0], dist.get_world_size(), dist.get_rank()
        rows = torch.rand((n * world, *shape[1:]), generator=gen)[rank * n:(rank + 1) * n]
        return rows < 1.0 - self.rate

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if key is None:
            raise ValueError("a training forward with dropout needs its key "
                             "(RNG_SEED, step, micro-batch): trainer.train_step sets it")
        if isinstance(key, DropoutSlot):
            keep = key.mask(self, x)
        else:
            keep = self.draw(key, x.shape)
            if x.device.type == "cuda":
                keep = keep.pin_memory().to(x.device, non_blocking=True)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class DropoutSlot:
    """One micro-batch's dropout key with its masks in static device
    buffers, one per :class:`Dropout` layer it meets: :meth:`set_key`
    (host, before the call) draws each layer's mask for the key into its
    buffer (``graphs.stage``); a forward reads the buffer. A layer's
    buffer is made, and filled, at its first forward, which is never a
    capture (a StepGraph's first call runs eagerly)."""

    def __init__(self):
        self.key = None
        self._masks: dict = {}  # id(layer) -> (layer, device bool buffer)

    def set_key(self, key) -> None:
        self.key = tuple(key)
        for layer, buf in self._masks.values():
            graphs.stage(buf, layer.draw(self.key, buf.shape))

    def mask(self, layer: Dropout, x: torch.Tensor) -> torch.Tensor:
        entry = self._masks.get(id(layer))
        if entry is None:
            if graphs.capturing():
                raise RuntimeError("a dropout slot's buffer is made at the step's first, "
                                   "eager call, not under capture")
            buf = torch.empty(x.shape, dtype=torch.bool, device=x.device)
            graphs.stage(buf, layer.draw(self.key, x.shape))
            entry = self._masks[id(layer)] = (layer, buf)
        if entry[1].shape != x.shape:
            raise ValueError(f"dropout slot holds masks of {tuple(entry[1].shape)}, the "
                             f"forward gives {tuple(x.shape)}")
        return entry[1]


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation gate on NHWC input (counterpart of
    ``layers.SqueezeExcite``): the squeeze is a mean over H and W that
    accumulates in fp32 and is cast to the compute dtype, then a 1x1 conv
    with bias → ``act`` (relu, RegNet's; EfficientNet passes silu) → a 1x1
    conv with bias → sigmoid, in the compute dtype with fp32 parameters;
    returns ``x * gate``. The two convs are ``names`` (timm's RegNet
    ``fc1``/``fc2`` by default, its EfficientNet ``conv_reduce``/
    ``conv_expand``). In eval the compute-dtype weights are cast once
    (``prepare()``)."""

    def __init__(self, channels: int, se_width: int, dtype: torch.dtype = torch.bfloat16,
                 act=F.relu, names: tuple[str, str] = ("fc1", "fc2"), device=None):
        super().__init__()
        self.dtype, self.act, self.names = dtype, act, names
        setattr(self, names[0], nn.Conv2d(channels, se_width, 1, device=device))
        setattr(self, names[1], nn.Conv2d(se_width, channels, 1, device=device))
        self._cache = None

    def _weights(self):
        reduce, expand = (getattr(self, n) for n in self.names)
        return [t.reshape(t.shape[0], -1).to(self.dtype) if t.dim() == 4 else t.to(self.dtype)
                for t in (reduce.weight, reduce.bias, expand.weight, expand.bias)]

    def prepare(self) -> None:
        with torch.no_grad():
            self._cache = self._weights()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            w1, b1, w2, b2 = self._weights()
        else:
            if self._cache is None:
                self.prepare()
            w1, b1, w2, b2 = self._cache
        s = x.to(torch.promote_types(torch.float32, x.dtype)).mean(dim=(1, 2)).to(self.dtype)
        s = torch.sigmoid(F.linear(self.act(F.linear(s, w1, b1)), w2, b2))
        return x * s[:, None, None, :]


class CNN(nn.Module):
    """What the CNNs share: ``train()``/``eval()`` drop every eval cache
    (each is rebuilt from the current weights at the next eval), and
    ``prepare()`` builds them at once, once per entry into eval (the serving
    engine calls it at build; otherwise the first eval forward does).
    Subclasses define ``conv_units()``, every ConvBN (and :class:`Conv`)
    of the network; a submodule with an eval cache of its own (the SE
    gates, BoTNet's attention) has a ``prepare()`` and a ``_cache``."""

    def cached_units(self):
        """Everything with an eval cache: the conv units and the modules
        that keep one."""
        yield from self.conv_units()
        yield from (m for m in self.modules()
                    if m is not self and hasattr(m, "_cache") and hasattr(m, "prepare"))

    def train(self, mode: bool = True):
        super().train(mode)
        for unit in self.cached_units():
            unit._cache = None
        return self

    def prepare(self):
        for unit in self.cached_units():
            unit.prepare()
        return self


class Dense(nn.Linear):
    """Linear head computed in the input's dtype (the head dtype);
    column-parallel when ``parallel/partition/specs.place_model`` gives it
    a ``shard`` (``parallel/tp.linear``)."""

    shard = None
    bias_sharded = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.shard,
                         self.bias_sharded)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last dim, with torch's parameter
    names (``weight`` for flax's ``scale``, ``bias``) in fp32.

    Not ``F.layer_norm``: flax takes ``epsilon = 1e-6`` and the fast
    variance ``E[x²] − E[x]²`` clamped at 0, with the statistics and the
    affine in at least fp32, and casts the result to the compute dtype."""

    eps = 1e-6

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(torch.float32, x.dtype))
        mu = xf.mean(-1, keepdim=True)
        var = clamp0(torch.square(xf).mean(-1, keepdim=True) - torch.square(mu))
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC global average pooling (mean in the compute dtype)."""
    return x.mean(dim=(1, 2))


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (2, 2), strides=(2, 2))`` on NHWC: VALID
    windows (an odd last row or column is dropped)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def build_on(cls, *args, generator=None, device=None, **kw):
    """Build ``cls(*args, **kw)`` on the meta device, materialise it on
    ``device`` (default CPU) and fill every weight from ``generator``
    (default seed 0)."""
    with torch.device("meta"):
        model = cls(*args, **kw)
    model.to_empty(device=device or "cpu")
    init_weights(model, generator or torch.Generator().manual_seed(0))
    return model


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, stride 2, padding 1) on NHWC; pads with -inf."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, in module definition order: convs
    kaiming-normal (fan_out, relu), a conv with a bias (the SE gate's) or
    marked ``lecun_init`` (BoTNet's q/k/v) flax's default instead, normal
    with std sqrt(1/fan_in) (lecun normal, untruncated here) and a zero
    bias; a module with ``init_params(generator)`` fills its own
    parameters there; Linear U(±1/sqrt(fan_in)) with zero
    bias, BN weight 1 (or 0 where zero-initialised), bias 0, stats 0/1.
    Every value is written, so the model may be built on the meta device
    and materialised with ``to_empty`` first. Conv weights are stored
    channels last, the layout cuDNN computes in, so their gradients, the
    optimizer's moments and the weights share one memory layout."""
    for m in model.modules():
        if hasattr(m, "init_params"):  # a module's own parameters (BoTNet's tables)
            m.init_params(generator)
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
            taps = m.kernel_size[0] * m.kernel_size[1]
            if m.bias is None and not getattr(m, "lecun_init", False):
                m.weight.normal_(0.0, math.sqrt(2.0 / (m.out_channels * taps)),
                                 generator=generator)
            else:
                fan_in = m.in_channels // m.groups * taps
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
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
