"""Grouped 3x3 "same" convolution (counterpart of distribuuuu_tpu/ops/group_conv.py).

x is NHWC ``[B, H, W, C]``, the JAX layout; the weight is the port's conv
parameter ``[C_out, cg, 3, 3]`` (the JAX ``[3, 3, cg, C_out]`` after
``utils/weights._port_layout``) stored channels last, so its memory order
is ``[C_out, 3, 3, cg]``. Padding is one pixel each side, the stride 1 or
2, the accumulator fp32 (fp64 for fp64 input on the CPU), the output in
x's dtype, ``[B, ceil(H/s), ceil(W/s), C_out]``.

On a CUDA tensor :func:`group_conv3x3` launches the kernel
(``csrc/group_conv.cu``, bf16 or f32) or raises; on a CPU tensor it runs
:func:`group_conv3x3_plain`, the tap accumulation of the TPU kernel. A
bf16 call whose cg and fg are multiples of 8 and whose bases are 16-byte
aligned (every RegNet and ResNeXt site) runs the Hopper body: A gathered
into a swizzled shared-memory ring, the weight loaded by TMA as it is
stored, ``wgmma``, tiled by :func:`plan`; any other bf16 call runs the
first design's ``mma.sync`` body (:func:`kernel_body` says which). The
backward mirrors ``_bwd`` of the JAX package: dx of a stride-1 conv is the
same kernel on the cotangent with the spatially flipped, per-group
transposed weight (counted in ``group_conv3x3.launches_dx``); dx of a
stride-2 conv and dW are library calls (``torch.nn.grad``), as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distribuuuu_tpu_torch.ops import cuda as kernel_tier

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPATIAL = 14  # the JAX gate: larger grids stay on the library conv


def _geometry(x, weight, stride: int, groups: int):
    """(B, H, W, cg, fg, Ho, Wo) of a call, checking what every version
    takes: NHWC x, a [G·fg, cg, 3, 3] weight, stride 1 or 2."""
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"group conv takes NHWC x and a [C_out, cg, 3, 3] weight, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"group conv: stride {stride} is not 1 or 2")
    b, h, w, c = x.shape
    c_out, cg = weight.shape[:2]
    if groups < 1 or c % groups or c_out % groups or c // groups != cg:
        raise ValueError(f"group conv: channels in={c} out={c_out} with weight cg={cg} "
                         f"do not split into groups={groups}")
    return b, h, w, cg, c_out // groups, -(-h // stride), -(-w // stride)


def group_conv3x3_plain(x, weight, stride: int = 1, groups: int = 1):
    """The plain version: nine shifted (stride 2: strided) slices of the
    zero-padded input per group, each contracted against ``w[:, :, dy,
    dx]`` of that group, summed in fp32 (fp64 for fp64 input), cast to
    ``x.dtype``. The CPU path and the kernel's reference on the card."""
    b, _, _, cg, fg, ho, wo = _geometry(x, weight, stride, groups)
    acc_dtype = torch.promote_types(torch.float32, x.dtype)
    xp = torch.nn.functional.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    wg = weight.to(acc_dtype).reshape(groups, fg, cg, 3, 3)
    acc = torch.zeros((b, ho, wo, groups, fg), dtype=acc_dtype, device=x.device)
    span_h, span_w = (ho - 1) * stride + 1, (wo - 1) * stride + 1
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + span_h:stride, dx:dx + span_w:stride]
            acc += torch.einsum("bhwgc,gfc->bhwgf",
                                xs.reshape(b, ho, wo, groups, cg), wg[..., dy, dx])
    return acc.reshape(b, ho, wo, groups * fg).to(x.dtype)


# ---------------------------------------------------------------------------
# the bf16 wgmma body's tiling
# ---------------------------------------------------------------------------

SMS = 132  # streaming multiprocessors of the H100 SXM
KC = 64  # k of one ring stage: one 128-byte swizzle row of bf16
MAX_SMEM = 232448  # dynamic shared memory a block may use
SM_SMEM = 233472  # shared memory of an SM, 1 KB of it reserved for each block
WGMMA_N = (16, 112, 128, 232)  # group widths the wgmma body runs as one N tile


class GroupPlan(NamedTuple):
    """The wgmma body's tiling: consumer warpgroups of a block (64 output
    pixels each) and the stages of its shared-memory ring."""

    warpgroups: int
    stages: int


def kernel_body(x, weight, groups: int) -> str:
    """The body the launcher runs for this call on the card: ``wgmma``
    (bf16, cg and fg multiples of 8, 16-byte aligned bases), ``mma_sync``
    (any other bf16 call) or ``f32``."""
    if x.dtype != torch.bfloat16:
        return "f32"
    c_out, cg = weight.shape[:2]
    aligned = x.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0
    return "wgmma" if cg % 8 == 0 and (c_out // groups) % 8 == 0 and aligned else "mma_sync"


def n_tile(fg: int) -> int:
    """The N tile of the wgmma body: fg at the widths it is built for
    (:data:`WGMMA_N`), else tiles of 64 (the launcher's ``n_tile``)."""
    return fg if fg in WGMMA_N else 64


def blocks_per_sm(warpgroups: int, fg: int) -> int:
    """Blocks of a tiling an SM holds by registers: two of one warpgroup
    at N ≤ 128 (the kernel's ``MIN_BLOCKS``), else one."""
    return 2 if warpgroups == 1 and n_tile(fg) <= 128 else 1


def max_stages(warpgroups: int, fg: int, per_sm: int = 1) -> int:
    """The most ring stages a block of this tiling takes when ``per_sm``
    blocks share an SM's shared memory (a stage is 128 bytes for each of
    its 64·warpgroups rows of A and N rows of B, and 16 of barriers; 1 KB
    aligns the ring)."""
    budget = MAX_SMEM if per_sm == 1 else SM_SMEM // per_sm - 1024
    return (budget - 1024) // ((64 * warpgroups + n_tile(fg)) * 128 + 16)


TWO_WG_N = (112, 232)  # N tiles measured faster with two consumer warpgroups


@functools.lru_cache(maxsize=None)
def plan(m: int, groups: int, cg: int, fg: int, stride: int) -> GroupPlan:
    """The wgmma body's tiling of ``m`` output pixels of ``groups`` groups,
    ``cg`` channels in and ``fg`` out a group, at ``stride`` (1 or 2: the
    gather takes both alike), as measured on the H100 (``PERF.md`` §6,
    ``group_conv_sweep.py``).

    * two consumer warpgroups (128-pixel tiles, one block an SM) where
      128-pixel tiles make two waves or more of the 132 SMs and the N tile
      is one of :data:`TWO_WG_N` (regnety_160 and regnety_320: each
      weight stage read from L2 feeds twice the rows); else one (64
      pixels, two blocks an SM, two producers gathering): at regnety_160's
      serving batch 8 (143 blocks of 128 would fill 1.08 waves), and at
      regnetx_160's fg 128 (batch 64) and ResNeXt's 16 (batch 8), where
      it measured faster;
    * as many ring stages as fit in the shared memory of the blocks an SM
      holds (:func:`blocks_per_sm`), no more than the K steps of 64.
    """
    bn = n_tile(fg)
    tiles_128 = -(-m // 128) * groups * -(-fg // bn)
    wg = 2 if tiles_128 >= 2 * SMS and bn in TWO_WG_N else 1
    k_steps = -(-9 * cg // KC)
    return GroupPlan(wg, min(k_steps, max_stages(wg, fg, blocks_per_sm(wg, fg))))


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("group_conv")
    fn = lib.group_conv3x3_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, weight, stride: int, groups: int, tiling: GroupPlan | None = None):
    """One launch of the kernel on CUDA tensors, the wgmma body tiled by
    ``tiling`` (default :func:`plan`); raises on what it does not take (no
    silent copy: x must be contiguous NHWC and the weight in channels-last
    memory order)."""
    b, h, w, cg, fg, ho, wo = _geometry(x, weight, stride, groups)
    if weight.device != x.device:
        raise ValueError(f"group conv: weight on {weight.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or weight.dtype != x.dtype:
        raise TypeError(f"group conv kernel takes bf16 or f32 x with a weight of the same "
                        f"dtype, got x {x.dtype}, weight {weight.dtype}")
    if not x.is_contiguous():
        raise ValueError("group conv kernel reads x as contiguous NHWC [B, H, W, C]")
    if not weight.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("group conv kernel reads the weight [C_out, cg, 3, 3] in "
                         "channels-last memory order ([C_out, 3, 3, cg])")
    if b * ho * wo >= 2**31 or x.numel() >= 2**62:
        raise ValueError(f"group conv: {b}x{ho}x{wo} output pixels is out of the kernel's range")
    if b * h * w >= 2**31:
        raise ValueError(f"group conv: {b}x{h}x{w} input pixels is out of the kernel's range")
    tiling = tiling or plan(b * ho * wo, groups, cg, fg, stride)
    out = torch.empty((b, ho, wo, groups * fg), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().group_conv3x3_launch(x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                                          b, h, w, groups, cg, fg, stride,
                                          _DTYPE_CODE[x.dtype], *tiling, stream)
    if err != 0:
        raise RuntimeError(f"group_conv3x3_launch failed: CUDA error {err}")
    return out


def _conv(x, weight, stride: int, groups: int, dx: bool = False):
    if not kernel_tier.choose(x, "group_conv"):
        return group_conv3x3_plain(x, weight, stride, groups)
    out = _launch(x, weight, stride, groups)
    if dx:
        group_conv3x3.launches_dx += 1
    else:
        group_conv3x3.launches += 1
    return out


def flipped_weight(weight, groups: int):
    """The weight of the stride-1 dx conv: ``w_t[g·cg + c, f, dy, dx] =
    w[g·fg + f, c, 2 − dy, 2 − dx]`` (spatial flip, in/out transposed per
    group), channels last. Tiny; plain torch."""
    c_out, cg = weight.shape[:2]
    fg = c_out // groups
    wt = weight.reshape(groups, fg, cg, 3, 3).flip(3, 4).transpose(1, 2)
    return wt.reshape(groups * cg, fg, 3, 3).contiguous(memory_format=torch.channels_last)


class _GroupConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride: int, groups: int):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.groups = stride, groups
        return _conv(x, weight, stride, groups)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        s, groups = ctx.stride, ctx.groups
        dy = dy.contiguous()  # the kernel reads contiguous NHWC
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if s == 1:
                dx = _conv(dy, flipped_weight(weight, groups), 1, groups, dx=True)
            else:
                dx = torch.nn.grad.conv2d_input(
                    x.permute(0, 3, 1, 2).shape, weight, dy.permute(0, 3, 1, 2), s, 1, 1,
                    groups).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), weight.shape,
                                             dy.permute(0, 3, 1, 2), s, 1, 1, groups)
        return dx, dw, None, None


def group_conv3x3(x, weight, stride: int = 1, groups: int = 1):
    """Grouped 3x3 conv, "same" padding, differentiable in x and weight.

    x: [B, H, W, C] NHWC; weight: [C_out, cg, 3, 3] with cg = C / groups,
    channels-last memory order on the card. Returns [B, ceil(H/s),
    ceil(W/s), C_out] in x's dtype. A CUDA tensor runs the kernel (one
    added to ``group_conv3x3.launches``; the stride-1 dx adds one to
    ``group_conv3x3.launches_dx``); a CPU tensor runs
    :func:`group_conv3x3_plain`.
    """
    return _GroupConv.apply(x, weight, int(stride), int(groups))


group_conv3x3.launches = 0
group_conv3x3.launches_dx = 0


def qualifies(kernel_size, strides, padding, h: int, w: int) -> tuple[bool, str]:
    """(supported, reason) for one grouped-conv site under
    ``DISTRIBUUUU_GROUP_CONV=pallas``: the gate of the JAX
    ``UnrolledGroupConv`` (3x3, stride 1, padding ((1, 1), (1, 1)), H and W
    both ≤ 14), so one config sends the same sites to the kernel in both
    packages."""
    k = tuple(kernel_size)
    if k != (3, 3):
        return False, f"kernel {k} is not (3, 3)"
    s = strides if isinstance(strides, (tuple, list)) else (strides, strides)
    if tuple(s) != (1, 1):
        return False, f"stride {tuple(s)} != (1, 1) (no stride-2 VMEM slices on the TPU)"
    if [tuple(p) for p in padding] != [(1, 1), (1, 1)]:
        return False, f"padding {padding} != ((1, 1), (1, 1))"
    if h > MAX_SPATIAL or w > MAX_SPATIAL:
        return False, f"spatial {h}x{w} > {MAX_SPATIAL}x{MAX_SPATIAL}"
    return True, ""


def pass_bytes(b: int, h: int, w: int, c: int, c_out: int, cg: int, stride: int,
               dtype) -> int:
    """Bytes one call must move: x read once, the weight read once, the
    output written once."""
    isz = torch.empty((), dtype=dtype).element_size()
    ho, wo = -(-h // stride), -(-w // stride)
    return (b * h * w * c + c_out * cg * 9 + b * ho * wo * c_out) * isz


def pass_flops(b: int, h: int, w: int, c_out: int, cg: int, stride: int) -> int:
    """Operations of one call: a multiply and an add for each of the 9·cg
    taps of every output element."""
    ho, wo = -(-h // stride), -(-w // stride)
    return 2 * b * ho * wo * 9 * cg * c_out
