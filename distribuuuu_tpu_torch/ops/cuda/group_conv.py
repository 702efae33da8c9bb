"""Grouped 3x3 "same" convolution (counterpart of distribuuuu_tpu/ops/group_conv.py).

x is NHWC ``[B, H, W, C]``, the JAX layout; the weight is the port's conv
parameter ``[C_out, cg, 3, 3]`` (the JAX ``[3, 3, cg, C_out]`` after
``utils/weights._port_layout``) stored channels last, so its memory order
is ``[C_out, 3, 3, cg]``. Padding is one pixel each side, the stride 1 or
2, the accumulator fp32 (fp64 for fp64 input on the CPU), the output in
x's dtype, ``[B, ceil(H/s), ceil(W/s), C_out]``.

On a CUDA tensor :func:`group_conv3x3` launches the kernel
(``csrc/group_conv.cu``, bf16 or f32) or raises; on a CPU tensor it runs
:func:`group_conv3x3_plain`, the tap accumulation of the TPU kernel. The
backward mirrors ``_bwd`` of the JAX package: dx of a stride-1 conv is the
same kernel on the cotangent with the spatially flipped, per-group
transposed weight (counted in ``group_conv3x3.launches_dx``); dx of a
stride-2 conv and dW are library calls (``torch.nn.grad``), as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import ctypes

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


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("group_conv")
    fn = lib.group_conv3x3_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, weight, stride: int, groups: int):
    """One launch of the kernel on CUDA tensors; raises on what it does not
    take (no silent copy: x must be contiguous NHWC and the weight in
    channels-last memory order)."""
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
    out = torch.empty((b, ho, wo, groups * fg), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().group_conv3x3_launch(x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                                          b, h, w, groups, cg, fg, stride,
                                          _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"group_conv3x3_launch failed: CUDA error {err}")
    return out


def _conv(x, weight, stride: int, groups: int, dx: bool = False):
    if not kernel_tier.use_kernel(x):
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
