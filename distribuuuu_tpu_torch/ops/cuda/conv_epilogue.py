"""Fused pointwise conv + BN-affine + activation (the eval epilogue).

Counterpart of ``distribuuuu_tpu/ops/pallas/conv_epilogue.py``. A 1x1/s1
conv is a matmul ``[B·H·W, Cin] x [Cin, Cout]`` over the NHWC rows, and
eval BatchNorm is a per-channel affine, so the site computes
``act((x·W)·a + c)`` with ``a = rsqrt(var+eps)·scale`` and
``c = bias − mean·a``. The CUDA kernel (``csrc/conv_epilogue.cu``) applies
the affine and the activation to the fp32 accumulator in registers: one
read of the activations and the weights, one write of the activated
output, nothing in between.

The bf16 kernel is a Hopper GEMM (TMA ring, wgmma, optional split-K) whose
tile and split of K are a :func:`plan` chosen here by the site's shape and
cached per shape. A split-K plan sums fp32 partials in a workspace that
this module keeps per (device, stream), allocated at the first call that
needs it and grown when a later one needs more; the kernel leaves its
arrival counters at 0, so no call clears it.

On a CUDA tensor :func:`conv1x1_bn_act` launches the kernel or raises; on
a CPU tensor it runs :func:`conv1x1_bn_act_plain`. Numerics against the
unfused chain: the accumulator stays fp32 into the affine (the unfused
path rounds the conv output to the compute dtype first), so bf16 outputs
agree to bf16 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

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


SMS = 132  # streaming multiprocessors of the H100 SXM
BK = 64  # K of one ring stage: one 128-byte swizzle row of bf16
MIN_SPLIT_STEPS = 2  # K steps a split must keep
MAX_SMEM = 232448  # dynamic shared memory a block may use
MAX_STAGES = 5
# a split plan has at most two waves of units, and only 128 x 64, 128 x 128
# or 64 x 128 tiles split (128 x 256 tiles are plentiful): the bound on the
# fp32 partials of one launch
MAX_WORKSPACE_BYTES = 2 * SMS * 128 * 128 * 4


def _tiles(m: int, n: int, bm: int, bn: int) -> int:
    return -(-m // bm) * -(-n // bn)


def _cost(tiles: int, steps: int, splits: int) -> int:
    """K steps of the busiest SM (one CTA per SM), plus two for a unit's
    first load and its epilogue and three for writing and summing the
    partials of a split."""
    return -(-tiles * splits // SMS) * (steps // splits + 2 + 3 * (splits > 1))


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> tuple[int, int, int, int]:
    """(bm, bn, splits, stages) of the bf16 kernel for ``[m, k] x [k, n]``.

    * bn covers N up to 256 (64, 128 or 256), so x is read once; wider N
      takes 256-column tiles, which read the fewest bytes from L2 for each
      product (the kernel reads x again for each column tile);
    * where 128 x bn tiles would leave most of the 132 SMs idle, bn 256
      drops to 128, and then bm to 64 (with bn 128 only: the two consumer
      warpgroups then split the columns);
    * K is split (splits divide the K steps of 64, each keeps at least
      MIN_SPLIT_STEPS) only where the tiles fill at most a quarter of the
      SMs, into the split that lowers :func:`_cost`, within two waves;
    * the ring holds up to MAX_STAGES stages, as many as fit in shared
      memory beside the epilogue's bf16 staging (the kernel is persistent
      and its ring runs on across tiles, so a stage past a tile's K steps
      prefetches the next tile).
    """
    steps = -(-k // BK)
    bn = 64 if n <= 64 else 128 if n <= 128 else 256
    bm = 128
    if bn == 256 and 2 * _tiles(m, n, 128, bn) <= SMS:
        bn = 128
    if bn > 64 and 2 * _tiles(m, n, 128, bn) <= SMS:
        bm = 64
    tiles = _tiles(m, n, bm, bn)
    splits = 1
    if 4 * tiles <= SMS:
        for d in range(2, steps // MIN_SPLIT_STEPS + 1):
            if steps % d == 0 and tiles * d <= 2 * SMS \
                    and _cost(tiles, steps, d) < _cost(tiles, steps, splits):
                splits = d
    return bm, bn, splits, min(MAX_STAGES, _ring_room(bm, bn) // ((bm + bn) * BK * 2 + 16))


def _ring_room(bm: int, bn: int) -> int:
    """Shared memory left for the ring (the kernel's layout, bf16 out):
    alignment, two consumers' staged rows and affine, the flag."""
    part = bn if bm == 128 else bn // 2
    return MAX_SMEM - 1024 - 2 * 64 * part * 2 - 4 * part * 4 - 16


def workspace_bytes(m: int, n: int, k: int) -> int:
    """Bytes of fp32 partials a launch of :func:`plan` needs (0 unsplit)."""
    bm, bn, splits, _ = plan(m, n, k)
    return 0 if splits == 1 else _tiles(m, n, bm, bn) * splits * bm * bn * 4


# (device index, stream handle) -> (fp32 partials, int32 arrival counters)
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, floats: int, tiles: int):
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tiles:
        old_f, old_t = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(floats, old_f), dtype=torch.float32, device=device),
              torch.zeros(max(tiles, old_t), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


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
    bm, bn, splits, stages = plan(m, cout, cin)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        parts = arrivals = None
        if splits > 1 and x.dtype == torch.bfloat16:
            parts, arrivals = _workspace(x.device, stream, workspace_bytes(m, cout, cin) // 4,
                                         _tiles(m, cout, bm, bn))
        err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), c.data_ptr(),
                 out.data_ptr(), m, cout, cin, _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[out_dtype], _ACT_CODE[act], bm, bn, splits, stages,
                 parts.data_ptr() if parts is not None else None,
                 arrivals.data_ptr() if arrivals is not None else None, stream)
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
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, vp, vp, vp]
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
