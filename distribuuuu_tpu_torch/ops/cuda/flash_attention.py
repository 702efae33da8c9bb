"""Flash attention: forward, dQ and dK/dV (counterpart of
distribuuuu_tpu/ops/flash_attention.py).

Exact softmax attention that never writes the ``L × L`` scores or
probabilities to device memory. The forward saves the log-sum-exp
``[B, H, L]``; the backward recomputes the probabilities from it, with one
kernel accumulating dQ over key tiles and one accumulating dK/dV over
query tiles (``csrc/flash_attention.cu``). ``delta = Σ_d dO·O`` is computed
outside the kernels in fp32, as the JAX package does, and the cotangent of
the log-sum-exp (:func:`flash_attention_with_lse`) folds into it, so both
backward kernels take it unchanged.

On CUDA tensors the three kernels run (each adds one to its counter,
``fwd_launches``, ``dq_launches``, ``dkdv_launches``) or the call raises;
on CPU tensors their plain versions run (:func:`forward_plain`,
:func:`dq_plain`, :func:`dkdv_plain`), in fp32 with the kernels' rounding
points: p rounded to the input dtype before ``p·V`` and ``pᵀ·dO``, dS
before ``dS·K`` and ``dSᵀ·Q``.

What the TPU version needed and this one does not: block sizes
(``blk_q``/``blk_k``), the interpreter switch, and the fallback to the
blockwise scan past the VMEM residency bound (``fits_vmem``). Those are
facts of the TPU's VMEM. The CUDA kernels stream K/V (and Q/dO) from
device memory in 64-row tiles, so they take any length. ``head_dim`` ≤ 128
stays a hard limit: the kernels are built for 32, 64 and 128, and another
head dim is zero-padded to the next of those (exact; the scale uses the
true head dim).

Which body a call runs is a fact of its dtype (:func:`kernel_body`):
bf16/f16 the TMA + ``wgmma`` kernels at head dims 64 and 128 (the
autograd Function zero-pads a head dim of 32 or less to 64 once, for the
forward and the backward: :func:`kernel_head_dim`), whose tilings are
:func:`fwd_plan` and :func:`bwd_plan` (pure, cached per shape); f32 the
CUDA-core kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distribuuuu_tpu_torch.ops import cuda as kernel_tier

NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)  # the masked score
BLOCK = 64  # the kernels' tile: query rows (forward, dQ), keys (dK/dV), streamed rows
HEAD_DIMS = (32, 64, 128)  # the head dims the kernels are built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

fwd_launches = 0
dq_launches = 0
dkdv_launches = 0


def launch_counts() -> dict[str, int]:
    return {"forward": fwd_launches, "dq": dq_launches, "dkdv": dkdv_launches}


def reset_launch_counts() -> None:
    global fwd_launches, dq_launches, dkdv_launches
    fwd_launches = dq_launches = dkdv_launches = 0


# ---------------------------------------------------------------------------
# plain versions: [BH, L, D] tensors, fp32 compute, the kernels' rounding
# ---------------------------------------------------------------------------


def forward_plain(q, k, v, scale: float, causal: bool):
    """``(o, lse)``: online softmax over key tiles of ``BLOCK``, the
    kernel's order, with p rounded to ``v.dtype`` before ``p·V``. o in
    ``v.dtype``, lse fp32 ``[BH, L]``."""
    bh, L, d = q.shape
    qf = q.float()
    m = torch.full((bh, L), NEG_BIG, device=q.device)
    l = torch.zeros((bh, L), device=q.device)
    acc = torch.zeros((bh, L, v.shape[-1]), device=q.device)
    rows = torch.arange(L, device=q.device)
    for k0 in range(0, L, BLOCK):
        kb, vb = k[:, k0:k0 + BLOCK].float(), v[:, k0:k0 + BLOCK]
        s = (qf @ kb.transpose(1, 2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = torch.where(cols[None, :] <= rows[:, None], s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ vb.float()
        m = m_new
    l_safe = l.clamp_min(1e-30)
    return (acc / l_safe[..., None]).to(v.dtype), m + torch.log(l_safe)


def _probs(q, k, do, v, lse, delta, scale, causal):
    """p = exp(s − lse) (0 where masked) and dS = p·(dP − delta)·scale."""
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        p = torch.where(pos[None, :] <= pos[:, None], p, 0.0)  # [query, key]
    dp = do.float() @ v.float().transpose(1, 2)
    return p, p * (dp - delta[..., None]) * scale


def dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dQ = dS·K, dS rounded to ``k.dtype``; in ``q.dtype``."""
    _, ds = _probs(q, k, do, v, lse, delta, scale, causal)
    return (ds.to(k.dtype).float() @ k.float()).to(q.dtype)


def dkdv_plain(q, k, v, do, lse, delta, scale: float, causal: bool):
    """``(dK, dV)``: dV = pᵀ·dO with p rounded to ``do.dtype``, dK = dSᵀ·Q
    with dS rounded to ``q.dtype``."""
    p, ds = _probs(q, k, do, v, lse, delta, scale, causal)
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    dk = ds.to(q.dtype).float().transpose(1, 2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' bodies and tilings
# ---------------------------------------------------------------------------

WGMMA_HEAD_DIMS = (64, 128)  # the head dims of the 16-bit TMA + wgmma bodies
SHORT = 1024  # tokens up to which a sequence's blocks are few and short (ViT at 224²)


class FwdPlan(NamedTuple):
    """The forward's body and, for ``wgmma``, its tiling: the consumer
    warpgroups of a block (64 query rows each), the keys of a K/V tile and
    the stages of the K/V ring (the f32 body takes none: zeros)."""

    body: str
    warpgroups: int
    key_tile: int
    stages: int


class BwdPlan(NamedTuple):
    """The backward's body and, for ``wgmma``, the tiling of dK/dV: its
    query tile and the stages of its Q/dO ring (the f32 body takes none:
    zeros). dQ's ring is the kernel's own (two 64-key stages)."""

    body: str
    dkdv_bq: int
    dkdv_stages: int


def kernel_body(dtype: torch.dtype, d: int) -> str:
    """``wgmma`` (bf16/f16) or ``f32``, for the kernels' head dim ``d``;
    a 16-bit head dim the ``wgmma`` bodies are not built for raises (the
    autograd Function pads it, :func:`kernel_head_dim`)."""
    if dtype == torch.float32:
        return "f32"
    if d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"the 16-bit flash kernels run at head dims {WGMMA_HEAD_DIMS}, "
                         f"not {d}: pad to kernel_head_dim")
    return "wgmma"


def kernel_head_dim(dtype: torch.dtype, d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at, forward and
    backward: :func:`padded_head_dim`, and at least 64 in bf16/f16."""
    dp = padded_head_dim(d)
    return dp if dtype == torch.float32 else max(dp, WGMMA_HEAD_DIMS[0])


ONE_WG_SLOTS = 4 * 132  # one-warpgroup forward blocks the H100 holds at once (4 an SM)


@functools.lru_cache(maxsize=None)
def fwd_plan(bh: int, L: int, d: int, dtype: torch.dtype) -> FwdPlan:
    """The forward of one (batch·heads, length, kernel head dim, dtype),
    as measured on the H100 (``PERF.md`` §6, ``flash_fwd_sweep.py``).
    Each warpgroup runs S, the softmax and P·V of a tile in turn; the
    overlap comes from the other warpgroups on the SM. Long sequences
    take key tiles of 128 at d 64 (one warpgroup a block, three blocks an
    SM at 128 registers) and two warpgroups sharing 64-key tiles at d 128.
    Short ones (≤ SHORT tokens) take blocks of one warpgroup and 64-key
    tiles, four an SM at 96 registers, unless the query tiles fill more
    than four waves of those (ViT-S eval at batch 200): then two
    warpgroups share each K/V tile, halving the loads from L2. The ring
    holds two stages (one at d 128, short: three blocks an SM instead of
    two), four for two warpgroups on short sequences; never more than the
    sequence has key tiles. Causal shapes take the plans of the same shape."""
    body = kernel_body(dtype, d)
    if body != "wgmma":
        return FwdPlan(body, 0, 0, 0)
    if L > SHORT:
        wg, kt, stages = (1, 128, 2) if d == 64 else (2, 64, 2)
    elif bh * -(-L // BLOCK) > 4 * ONE_WG_SLOTS:
        wg, kt, stages = 2, 64, 4
    else:
        wg, kt, stages = 1, 64, 2 if d == 64 else 1
    return FwdPlan(body, wg, kt, min(stages, -(-L // kt)))


@functools.lru_cache(maxsize=None)
def bwd_plan(L: int, d: int, dtype: torch.dtype) -> BwdPlan:
    """The backward of one (length, kernel head dim, dtype), as measured on
    the H100 (``PERF.md`` §6). Both kernels run blocks of one consumer
    warpgroup (64 rows) and a producer warp, two or three to an SM (two
    warpgroups a block were slower at every shape measured). dK/dV
    streams Q/dO in tiles of 32 queries where the sequence is short
    (≤ SHORT tokens: three blocks an SM at 131 registers) or the head dim
    is 128 (the dK and dV accumulators of 64 keys × 128 take the
    registers), else 64 (fewer, wider products); its ring holds four tiles
    where the sequence is short (all of ViT-S's 196 tokens in flight at
    once), else two. Causal shapes take the plans of their length."""
    body = kernel_body(dtype, d)
    if body != "wgmma":
        return BwdPlan(body, 0, 0)
    short = L <= SHORT
    bq = 32 if short or d == 128 else 64
    return BwdPlan(body, bq, min(4 if short else 2, -(-L // bq)))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        head = [i, i, i, i, i, f]  # BH, L, D, dtype, causal, scale
        lib.flash_fwd_launch.argtypes = [vp] * 5 + head + [i, i, i, vp]  # wg, kt, stages, stream
        lib.flash_dq_launch.argtypes = [vp] * 7 + head + [vp]  # stream
        lib.flash_dkdv_launch.argtypes = [vp] * 8 + head + [i, i, vp]  # bq, stages, stream
        for fn in (lib.flash_fwd_launch, lib.flash_dq_launch, lib.flash_dkdv_launch):
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, *ts: torch.Tensor) -> None:
    """What the kernels take: one CUDA device, one dtype of f32/bf16/f16
    for the [BH, L, D] operands, D in HEAD_DIMS, contiguous, 16-byte
    aligned; fp32 [BH, L] lse/delta."""
    x = ts[0]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash {name} kernel takes f32, bf16 or f16, not {x.dtype}")
    bh, L, d = x.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash {name} kernel: head dim {d} not in {HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"flash {name} kernel: batch·heads {bh} > 65535")
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"flash {name}: operands on {t.device} and {x.device}")
        want = (x.dtype, (bh, L, d)) if t.dim() == 3 else (torch.float32, (bh, L))
        if (t.dtype, tuple(t.shape)) != want:
            raise TypeError(f"flash {name}: operand {t.dtype} {tuple(t.shape)}, want {want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash {name} kernel reads contiguous, 16-byte aligned operands")


def _call(fn, name: str, *ptrs, bh, L, d, dtype, causal, scale, device, plan=()):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, bh, L, d, _DTYPE_CODE[dtype], int(causal), float(scale), *plan, stream)
    if err != 0:
        raise RuntimeError(f"flash_{name}_launch failed: CUDA error {err}")


def forward_kernel(q, k, v, scale: float, causal: bool):
    """The forward kernel on [BH, L, D] CUDA tensors: ``(o, lse)``."""
    global fwd_launches
    _check("forward", q, k, v)
    bh, L, d = q.shape
    p = fwd_plan(bh, L, d, q.dtype)  # raises at a head dim the 16-bit body is not built for
    if p.body == "wgmma" and scale < 0:  # the body takes scale ≥ 0: (−q)·k·(−scale), exact
        q, scale = -q, -scale
    o = torch.empty_like(v)
    lse = torch.empty((bh, L), dtype=torch.float32, device=q.device)
    _call(_lib().flash_fwd_launch, "fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), lse.data_ptr(), bh=bh, L=L, d=d, dtype=q.dtype, causal=causal,
          scale=scale, device=q.device, plan=(p.warpgroups, p.key_tile, p.stages))
    fwd_launches += 1
    return o, lse


def dq_kernel(q, k, v, do, lse, delta, scale: float, causal: bool):
    """The dQ kernel on [BH, L, D] CUDA tensors."""
    global dq_launches
    _check("dq", q, k, v, do, lse, delta)
    bh, L, d = q.shape
    kernel_body(q.dtype, d)  # raises at a head dim the 16-bit body is not built for
    dq = torch.empty_like(q)
    _call(_lib().flash_dq_launch, "dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh=bh, L=L, d=d,
          dtype=q.dtype, causal=causal, scale=scale, device=q.device)
    dq_launches += 1
    return dq


def dkdv_kernel(q, k, v, do, lse, delta, scale: float, causal: bool):
    """The dK/dV kernel on [BH, L, D] CUDA tensors: ``(dk, dv)``."""
    global dkdv_launches
    _check("dkdv", q, k, v, do, lse, delta)
    bh, L, d = q.shape
    p = bwd_plan(L, d, q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(_lib().flash_dkdv_launch, "dkdv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          bh=bh, L=L, d=d, dtype=q.dtype, causal=causal, scale=scale, device=q.device,
          plan=(p.dkdv_bq, p.dkdv_stages))
    dkdv_launches += 1
    return dk, dv


def _forward(q, k, v, scale, causal):
    if kernel_tier.choose(q, "flash_attention"):
        return forward_kernel(q, k, v, scale, causal)
    return forward_plain(q, k, v, scale, causal)


def _dq(*args):
    if kernel_tier.choose(args[0], "flash_attention"):
        return dq_kernel(*args)
    return dq_plain(*args)


def _dkdv(*args):
    if kernel_tier.choose(args[0], "flash_attention"):
        return dkdv_kernel(*args)
    return dkdv_plain(*args)


# ---------------------------------------------------------------------------
# autograd and the public functions ([B, H, L, D], the JAX layout)
# ---------------------------------------------------------------------------


def padded_head_dim(d: int) -> int:
    """The kernel instance a head dim runs in (zero-padded up to it)."""
    for h in HEAD_DIMS:
        if d <= h:
            return h
    raise ValueError(f"head_dim {d} > {HEAD_DIMS[-1]}: the flash kernels are built up to "
                     f"{HEAD_DIMS[-1]}")


def _flat(t: torch.Tensor, dp: int) -> torch.Tensor:
    """[B, H, L, D] → contiguous [B·H, L, dp], zero-padded on the last dim."""
    b, h, L, d = t.shape
    t = t.reshape(b * h, L, d)
    if dp != d:
        t = torch.nn.functional.pad(t, (0, dp - d))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Flash(torch.autograd.Function):
    """``(o, lse)`` with the flash backward; an lse cotangent folds into
    delta (``delta − g_lse``), as ``_flash_backward`` of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        b, h, L, d = q.shape
        dp = kernel_head_dim(q.dtype, d) if kernel_tier.use_kernel(q) else d
        qf, kf, vf = (_flat(t, dp) for t in (q, k, v))
        o, lse = _forward(qf, kf, vf, scale, causal)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.scale, ctx.causal, ctx.shape = scale, causal, (b, h, L, d)
        ctx.set_materialize_grads(False)
        return o[..., :d].reshape(b, h, L, d), lse.reshape(b, h, L)

    @staticmethod
    def backward(ctx, g_o, g_lse):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, h, L, d = ctx.shape
        dp = qf.shape[-1]
        g = torch.zeros_like(o) if g_o is None else _flat(g_o.to(o.dtype), dp)
        delta = (g.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.reshape(b * h, L).float()
        args = (qf, kf, vf, g, lse, delta.contiguous(), ctx.scale, ctx.causal)
        dq = _dq(*args)
        dk, dv = _dkdv(*args)

        def unflat(t):
            return t[..., :d].reshape(b, h, L, d)

        return unflat(dq), unflat(dk), unflat(dv), None, None


def _prep(q, k, v, scale):
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"flash attention takes q, k, v of one [B, H, L, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {d} > {HEAD_DIMS[-1]}: the flash kernels are built up "
                         f"to {HEAD_DIMS[-1]}")
    return d ** -0.5 if scale is None else float(scale)


def flash_attention(q, k, v, *, scale: float | None = None, causal: bool = False):
    """Exact softmax attention. q, k, v: [B, H, L, D]; returns [B, H, L, D]
    in ``v.dtype``. Differentiable (flash backward: recompute from the
    saved log-sum-exp). ``causal`` masks keys past the query's position
    and skips the key tiles that are wholly masked."""
    return _Flash.apply(q, k, v, _prep(q, k, v, scale), bool(causal))[0]


def flash_attention_with_lse(q, k, v, *, scale: float | None = None, causal: bool = False):
    """:func:`flash_attention` that also returns the log-sum-exp
    ``[B, H, L]`` (fp32), differentiable in both outputs."""
    return _Flash.apply(q, k, v, _prep(q, k, v, scale), bool(causal))


def pass_bytes(bh: int, L: int, d: int, dtype: torch.dtype) -> dict[str, int]:
    """Bytes each kernel must move, every operand read once and every
    output written once: forward q, k, v → o, lse; dQ q, k, v, dO, lse,
    delta → dq; dK/dV q, k, v, dO, lse, delta → dk, dv."""
    t = bh * L * d * torch.empty((), dtype=dtype).element_size()
    vec = bh * L * 4
    return {"forward": 4 * t + vec, "dq": 5 * t + 2 * vec, "dkdv": 6 * t + 2 * vec}


def flops(bh: int, L: int, d: int, causal: bool = False) -> dict[str, float]:
    """Matrix-product operations of each kernel over the (query, key)
    pairs the mask keeps (L² or, causal, L(L+1)/2): 2 products of d in the
    forward (s, p·V), 3 in dQ (s, dP, dS·K), 4 in dK/dV (s, dP, pᵀ·dO,
    dSᵀ·Q), 2 operations each."""
    pairs = L * (L + 1) / 2 if causal else L * L
    one = 2.0 * bh * pairs * d
    return {"forward": 2 * one, "dq": 3 * one, "dkdv": 4 * one}
