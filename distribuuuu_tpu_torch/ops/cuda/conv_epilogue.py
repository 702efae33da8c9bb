"""Fused pointwise conv + BN-affine + activation (the eval epilogue).

Counterpart of ``distribuuuu_tpu/ops/pallas/conv_epilogue.py``. A 1x1/s1
conv is a matmul ``[B·H·W, Cin] x [Cin, Cout]`` over the NHWC rows, and
eval BatchNorm is a per-channel affine, so the site computes
``act((x·W)·a + c)`` with ``a = rsqrt(var+eps)·scale`` and
``c = bias − mean·a``. The CUDA kernel (``csrc/conv_epilogue.cu``) applies
the affine and the activation to the fp32 accumulator in registers: one
read of the activations and the weights, one write of the activated
output, nothing in between.

On a CUDA tensor :func:`conv1x1_bn_act` launches the kernel or raises; on
a CPU tensor it runs :func:`conv1x1_bn_act_plain`. Numerics against the
unfused chain: the accumulator stays fp32 into the affine (the unfused
path rounds the conv output to the compute dtype first), so bf16 outputs
agree to bf16 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch.ops import cuda as kernel_tier

# activation registry: code -> fp32 implementation of the plain version;
# the kernel's codes are the positions in this table
_ACTS = {
    "id": lambda y: y,
    "relu": torch.relu,
    "silu": F.silu,
}
_ACT_CODE = {name: i for i, name in enumerate(_ACTS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def act_code(fn) -> str | None:
    """Map an activation callable to its kernel code, or None when the
    kernel has no implementation for it."""
    if fn is None:
        return "id"
    if fn in (F.relu, torch.relu):
        return "relu"
    if fn in (F.silu,):
        return "silu"
    return None


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape[-2], w.shape[-1]) if w.dim() == 4 else w


def conv1x1_bn_act_plain(x, w, a, c, act: str = "id", out_dtype=None):
    """The plain PyTorch version: ``act((x·w)·a + c)`` in fp32, cast to
    ``out_dtype`` (default ``x.dtype``). The CPU path and the kernel's
    reference on the card."""
    if act not in _ACTS:
        raise ValueError(f"conv epilogue: unknown act {act!r} ({list(_ACTS)})")
    w = _as_matrix(w)
    y = (x.float() @ w.float()) * a.float() + c.float()
    return _ACTS[act](y).to(out_dtype or x.dtype)


def _launch(x, w, a, c, act, out_dtype):
    cin, cout = w.shape
    if x.shape[-1] != cin:
        raise ValueError(f"conv epilogue: x has {x.shape[-1]} channels, w expects {cin}")
    for name, t in (("w", w), ("a", a), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"conv epilogue: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(
            f"conv epilogue kernel takes bf16 or f32 x with w of the same dtype, "
            f"got x {x.dtype}, w {w.dtype}"
        )
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"conv epilogue kernel writes bf16 or f32, not {out_dtype}")
    if a.dtype != torch.float32 or c.dtype != torch.float32 or a.shape != (cout,) \
            or c.shape != (cout,):
        raise TypeError(
            f"conv epilogue: a, c must be fp32 [{cout}], got {a.dtype} "
            f"{tuple(a.shape)}, {c.dtype} {tuple(c.shape)}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and a.is_contiguous()
            and c.is_contiguous()):
        raise ValueError(
            "conv epilogue kernel reads x as a contiguous [M, Cin] view "
            "(NHWC, channels last) and w as a contiguous [Cin, Cout]"
        )
    m = x.numel() // cin
    if m >= 2**31 or m == 0:
        raise ValueError(f"conv epilogue: {m} rows is out of the kernel's range")
    out = torch.empty((*x.shape[:-1], cout), dtype=out_dtype, device=x.device)
    fn = _lib().conv_epilogue_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr(),
                 out.data_ptr(), m, cout, cin, _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[out_dtype], _ACT_CODE[act], stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue_launch failed: CUDA error {err}")
    conv1x1_bn_act.launches += 1
    return out


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("conv_epilogue")
    fn = lib.conv_epilogue_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return lib


def conv1x1_bn_act(x, w, a, c, act: str = "id", out_dtype=None):
    """``act((x ⊛ w) · a + c)`` for a pointwise conv, one fused pass.

    x: [..., Cin] (NHWC; leading dims flatten to rows);
    w: [Cin, Cout] or [1, 1, Cin, Cout];
    a, c: [Cout] fp32 (BN folded by the caller);
    act: ``id`` | ``relu`` | ``silu``.
    Returns [..., Cout] in ``out_dtype`` (default ``x.dtype``). A CUDA
    tensor runs the kernel (and adds one to ``conv1x1_bn_act.launches``);
    a CPU tensor runs :func:`conv1x1_bn_act_plain`.
    """
    if act not in _ACTS:
        raise ValueError(f"conv epilogue: unknown act {act!r} ({list(_ACTS)})")
    out_dtype = out_dtype or x.dtype
    if kernel_tier.use_kernel(x):
        return _launch(x, _as_matrix(w), a, c, act, out_dtype)
    return conv1x1_bn_act_plain(x, w, a, c, act, out_dtype)


conv1x1_bn_act.launches = 0


def qualifies(kernel_size, strides, padding, groups, act_fn,
              train: bool) -> tuple[bool, str]:
    """(supported, reason) for one conv+BN+act site; the reason names the
    disqualifier, in the JAX package's words."""
    if train:
        return False, "training forward (BN batch stats need the raw conv output)"
    k = tuple(kernel_size)
    if k != (1, 1):
        return False, f"kernel {k} is not pointwise (1, 1)"
    s = strides if isinstance(strides, (tuple, list)) else (strides, strides)
    if tuple(s) != (1, 1):
        return False, f"stride {tuple(s)} != (1, 1)"
    if padding is not None and any(p != (0, 0) for p in map(tuple, padding)):
        return False, f"padding {padding} != zero"
    if groups != 1:
        return False, f"grouped conv (groups={groups})"
    if act_code(act_fn) is None:
        return False, f"activation {getattr(act_fn, '__name__', act_fn)!r} has no kernel"
    return True, ""


def pass_bytes(m: int, cin: int, cout: int, in_dtype, out_dtype) -> int:
    """Bytes one fused pass must move: activations and weights read once,
    the affine vectors read once, the output written once."""
    isz = torch.empty((), dtype=in_dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    return m * cin * isz + cin * cout * isz + 2 * cout * 4 + m * cout * osz
