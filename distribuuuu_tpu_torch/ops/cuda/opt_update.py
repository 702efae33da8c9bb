"""Fused optimizer update: one pass over parameters, gradients and moments.

Counterpart of ``distribuuuu_tpu/ops/pallas/opt_update.py``. The optimizer
of ``utils/optim.py`` hands every step to :func:`update`, which updates the
parameters and the moment buffers in place:

* ``sgd`` with momentum (torch order: decay into the gradient, trace,
  Nesterov look-ahead), the trace in f32 or bf16;
* ``sgd`` without momentum (``mom == 0``, no trace);
* ``adamw`` (moments, bias correction ``c = 1 − βᵗ`` from the host,
  decoupled decay).

On CUDA tensors :func:`update` makes ONE launch of the kernel in
``csrc/opt_update.cu`` over all the leaves (a device table of their
pointers and sizes) and adds one to ``update.launches``; on CPU tensors it
runs :func:`update_plain`, the same arithmetic in PyTorch ops.

The step's constants (:data:`SCALARS`: the learning rate, the
hyperparameters and AdamW's bias corrections of step t) are not arguments
of the launch: they are a row of a device table, computed on the host by
:func:`scalar_rows` and staged there before the step, so that a captured
CUDA graph reads each replay's own (``graphs.py``). A device row index
picks the row (a fold of K steps stages K rows) and a device flag
``skip`` makes the step leave everything as it was. The plain version
reads the same tensors.

Rounding is the jitted JAX kernel's on the CPU, bit for bit: XLA contracts
``a·b + c`` into a fused multiply-add at fixed sites (the module docstring
of the CUDA source lists them), and rewrites AdamW's ``(mu/c1)/(√(nu/c2)+ε)``
as ``mu/(c1·(√(nu/c2)+ε))``. The plain version emulates each fused
multiply-add in f32 by an f64 product and sum rounded once to f32. A bf16
trace takes ``bf16(mom)·t`` (bf16 times bf16, exact in f32) inside the
fused add: XLA's CPU build keeps the product in f32 rather than rounding it
to bf16, so the effective decay is 0.8984375.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from distribuuuu_tpu_torch.ops import cuda as kernel_tier

KINDS = ("sgd", "adamw")
_KIND_CODE = {"sgd": 0, "sgd_plain": 1, "adamw": 2}


@dataclass(frozen=True)
class Hyper:
    """The step-invariant hyperparameters (the learning rate and the step
    count change per call)."""

    kind: str = "sgd"
    wd: float = 0.0
    mom: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def body(self) -> str:
        if self.kind not in KINDS:
            raise ValueError(f"fused optimizer update: unknown kind {self.kind!r}")
        return "sgd_plain" if self.kind == "sgd" and not self.mom else self.kind


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bf16(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.bfloat16))


SCALARS = ("lr", "wd", "mom", "mom_t", "b1", "b2", "ob1", "ob2", "eps", "c1", "c2")


def scalars(h: Hyper, lr: float, count: int, trace_dtype=torch.float32,
            dtype=torch.float32) -> dict:
    """The constants of one step for parameters of ``dtype``. In f32 they
    are rounded as the JAX kernel rounds its Python-float hyperparameters:
    ``mom`` to bf16 where it multiplies a bf16 trace, ``1 − β`` in f64 then
    to f32, and the bias corrections ``c = 1 − βᵗ`` by the f32 ``powf`` of
    the step count ``t``. Wider parameters keep them in f64."""
    if dtype != torch.float32:
        return {"lr": lr, "wd": h.wd, "mom": h.mom, "mom_t": h.mom, "b1": h.b1,
                "b2": h.b2, "ob1": 1.0 - h.b1, "ob2": 1.0 - h.b2, "eps": h.eps,
                "c1": 1.0 - h.b1 ** count, "c2": 1.0 - h.b2 ** count}
    one = np.float32(1.0)
    return {
        "lr": _f32(lr), "wd": _f32(h.wd), "mom": _f32(h.mom),
        "mom_t": _bf16(h.mom) if trace_dtype == torch.bfloat16 else _f32(h.mom),
        "b1": _f32(h.b1), "b2": _f32(h.b2),
        "ob1": _f32(1.0 - h.b1), "ob2": _f32(1.0 - h.b2), "eps": _f32(h.eps),
        "c1": float(one - np.float32(h.b1) ** np.float32(count)),
        "c2": float(one - np.float32(h.b2) ** np.float32(count)),
    }


def scalar_rows(h: Hyper, lr: float, first: int, k: int, trace_dtype=torch.float32,
                dtype=torch.float32) -> np.ndarray:
    """The :func:`scalars` of steps ``first`` .. ``first + k - 1`` as a
    ``[k, len(SCALARS)]`` array of ``dtype`` (f32 holds the f32-rounded
    values exactly; f64 keeps them in f64)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return np.array([[scalars(h, lr, first + i, trace_dtype, dtype)[key] for key in SCALARS]
                     for i in range(k)], npdt)


def staged_scalars(h: Hyper, lr: float, count: int, params, m=None) -> torch.Tensor:
    """One step's scalar row ``[1, len(SCALARS)]`` on ``params``' device:
    the table :func:`update` reads, for a caller that steps outside the
    optimizer (a test, a measurement)."""
    tdt = m[0].dtype if m and h.body() == "sgd" else torch.float32
    return torch.from_numpy(scalar_rows(h, lr, count, 1, tdt, params[0].dtype)).to(
        params[0].device)


# ---------------------------------------------------------------- plain version


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to ``a``'s dtype: for f32, the f64 product
    of two f32 values is exact and the f64 sum is rounded once to f32 (a
    fused multiply-add); wider dtypes compute it directly."""
    if a.dtype != torch.float32:
        return a * b + c
    return a.double().mul_(b).add_(c).float()


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE ``a / b`` in ``a``'s dtype. PyTorch divides by a Python scalar
    as a multiply by its reciprocal, which rounds differently; an f32
    quotient taken in f64 and rounded to f32 is the correctly rounded one."""
    if a.dtype != torch.float32:
        return a / b
    return a.double().div_(b).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """IEEE square root: PyTorch's vectorised f32 ``sqrt`` on the CPU is
    not correctly rounded; the f64 root rounded to f32 is."""
    return torch.sqrt(a.double()).float() if a.dtype == torch.float32 else torch.sqrt(a)


def _leaf_plain(body: str, nesterov: bool, s: dict, p, g, m, v) -> None:
    if body == "sgd":
        u = _fma(p, s["wd"], g)
        tn = _fma(m.to(p.dtype), s["mom_t"], u)
        upd = _fma(tn, s["mom"], u) if nesterov else tn
        p.copy_(_fma(upd, -s["lr"], p))
        m.copy_(tn)
    elif body == "sgd_plain":
        p.copy_(_fma(_fma(p, s["wd"], g), -s["lr"], p))
    else:
        mu = _fma(g, s["ob1"], m * s["b1"])
        nu = _fma(g * g, s["ob2"], v * s["b2"])
        den = (_sqrt(_div(nu, s["c2"])) + s["eps"]) * s["c1"]
        u = _fma(p, s["wd"], _div(mu, den))
        p.copy_(_fma(u, -s["lr"], p))
        m.copy_(mu)
        v.copy_(nu)


@torch.no_grad()
def update_plain(params, grads, m, v, h: Hyper, scal: torch.Tensor, row=None,
                 skip=None) -> None:
    """The plain PyTorch version of :func:`update`: leaf by leaf, the same
    arithmetic and rounding, reading the same table, row and flag. The
    CPU path, and the kernel's yardstick on the card."""
    if skip is not None and float(skip) != 0.0:
        return
    body = h.body()
    vals = scal[0 if row is None else int(row)].tolist()
    s = dict(zip(SCALARS, vals))
    for i, (p, g) in enumerate(zip(params, grads)):
        _leaf_plain(body, h.nesterov, s, p, g, m[i] if m else None, v[i] if v else None)


# ---------------------------------------------------------------- the kernel


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("opt_update")
    fn = lib.opt_update_launch
    if fn.argtypes is None:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, i, i64, i, i, i, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        lib.opt_update_chunk.restype = ctypes.c_int
        lib.opt_update_n_scalars.restype = ctypes.c_int
    return lib


def _rows(params, grads, m, v, chunk: int):
    rows, first = [], 0
    for i, (p, g) in enumerate(zip(params, grads)):
        n = p.numel()
        rows.append((p.data_ptr(), g.data_ptr(), m[i].data_ptr() if m else 0,
                     v[i].data_ptr() if v else 0, n, first))
        first += -(-n // chunk)
    return rows, first


def leaf_table(params, grads, m=None, v=None):
    """(device int64 table [L, 6], number of chunks): per leaf the pointers
    of p, g, m, v, its size, and the index of its first chunk. It stays
    right as long as none of these tensors moves: a caller whose leaves
    never move (the optimizer's own gradient buffers, which a CUDA graph
    reads) builds it once and passes it to every launch. Its copy to the
    card waits for the stream."""
    rows, n_chunks = _rows(params, grads, m, v, _lib().opt_update_chunk())
    return torch.tensor(rows, dtype=torch.int64).to(params[0].device), n_chunks


def _dense(t: torch.Tensor) -> bool:
    """Its elements fill ``numel`` consecutive slots (row-major, or channels
    last for a 4-d conv weight), so the kernel may walk the memory."""
    return t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last))


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Dense ``a`` and ``b`` of one shape hold their elements in the same
    memory order (strides of size-1 dims do not matter)."""
    return a.shape == b.shape and _dense(a) and _dense(b) and all(
        sa == sb for n, sa, sb in zip(a.shape, a.stride(), b.stride()) if n > 1)


def _check(params, grads, m, v, body: str) -> None:
    """Raise on any leaf the kernel cannot take. Runs on every launch, so
    the common case (equal strides, one device, one dtype) is compared
    directly and only a mismatch takes the slow layout test."""
    n = len(params)
    if len(grads) != n or (m and len(m) != n) or (v and len(v) != n):
        raise ValueError("fused optimizer update: params, grads and moments differ in count")
    dev = params[0].get_device()
    mdt = m[0].dtype if m else None
    f32 = torch.float32
    for i, (p, g) in enumerate(zip(params, grads)):
        leaf = [("param", p, f32), ("grad", g, f32)]
        if m:
            leaf.append(("moment", m[i], mdt))
        if v:
            leaf.append(("second moment", v[i], f32))
        stride = p.stride()
        if not _dense(p):
            raise ValueError(f"fused optimizer update: param {i} is not dense ({stride})")
        for name, t, dtype in leaf:
            if t.get_device() != dev:
                raise ValueError(f"fused optimizer update: {name} {i} on {t.device}, "
                                 f"params on {params[0].device}")
            if t.dtype != dtype:
                raise TypeError(f"fused optimizer update kernel takes f32 params and "
                                f"grads and one moment dtype; {name} {i} is {t.dtype}")
            if (t.stride() != stride or t.shape != p.shape) and not same_layout(t, p):
                raise ValueError(
                    f"fused optimizer update: {name} {i} must be a dense {tuple(p.shape)} "
                    f"tensor laid out as the param {stride}, got {t.stride()}")
    mts = (torch.float32, torch.bfloat16) if body == "sgd" else (torch.float32,)
    if m and mdt not in mts:
        raise TypeError(f"fused optimizer update: moments are {mdt}, the kernel takes "
                        f"{[str(t) for t in mts]}")


def _launch(params, grads, m, v, h: Hyper, scal, row, skip, table) -> None:
    body = h.body()
    _check(params, grads, m, v, body)
    lib = _lib()
    if scal.dtype != torch.float32 or scal.device != params[0].device or \
            scal.dim() != 2 or scal.shape[1] != lib.opt_update_n_scalars() or \
            not scal.is_contiguous():
        raise ValueError(f"fused optimizer update: the scalar table must be a contiguous "
                         f"f32 [rows, {lib.opt_update_n_scalars()}] tensor on "
                         f"{params[0].device}, got {scal.dtype} {tuple(scal.shape)} on "
                         f"{scal.device}")
    for name, t, dt in (("row", row, torch.int32), ("skip", skip, torch.float32)):
        if t is not None and (t.dtype != dt or t.device != scal.device or t.numel() != 1):
            raise ValueError(f"fused optimizer update: {name} must be one {dt} on "
                             f"{scal.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    tdt = m[0].dtype if body == "sgd" else torch.float32
    if table is None:
        from distribuuuu_tpu_torch import graphs

        if graphs.capturing():
            raise RuntimeError("fused optimizer update under graph capture needs the "
                               "leaves' table built beforehand (leaf_table)")
        table = leaf_table(params, grads, m, v)
    table, n_chunks = table
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.opt_update_launch(
            table.data_ptr(), len(params), n_chunks, _KIND_CODE[body],
            int(tdt == torch.bfloat16), int(h.nesterov), scal.data_ptr(),
            None if row is None else row.data_ptr(),
            None if skip is None else skip.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"opt_update_launch failed: CUDA error {err}")
    update.launches += 1


@torch.no_grad()
def update(params, grads, m, v, h: Hyper, scal: torch.Tensor, row=None, skip=None,
           table=None) -> None:
    """One optimizer step, in place, over every leaf.

    params, grads: lists of tensors of one shape per leaf (f32 on the card;
    each leaf's tensors dense and in one memory order, as the kernel walks
    their memory element by element);
    m: the SGD traces (f32 or bf16) or AdamW's first moments, or None for
    SGD without momentum; v: AdamW's second moments, else None;
    scal: the step constants, a ``[rows, len(SCALARS)]`` table on the
    params' device (:func:`scalar_rows`, :func:`staged_scalars`); row: a
    one-element int32 device tensor, the row this step reads (None: row
    0); skip: a one-element f32 device flag, nonzero to leave everything as
    it was (None: never); table: :func:`leaf_table`'s result for these
    leaves (None: built here, a copy that waits for the stream). CUDA tensors take one kernel
    launch (adding one to ``update.launches``); CPU tensors take
    :func:`update_plain`.
    """
    if not params:
        return
    if kernel_tier.choose(params[0], "opt_update"):
        return _launch(params, grads, m, v, h, scal, row, skip, table)
    return update_plain(params, grads, m, v, h, scal, row, skip)


update.launches = 0


def pass_bytes(params, m=None, v=None) -> int:
    """Bytes one fused pass must move: each param read and written, each
    gradient read, each moment read and written."""
    total = 0
    for i, p in enumerate(params):
        n = p.numel()
        total += n * (3 * p.element_size())
        if m:
            total += 2 * n * m[i].element_size()
        if v:
            total += 2 * n * v[i].element_size()
    return total
