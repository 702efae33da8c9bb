"""Decode attention over the paged KV cache (counterpart of
distribuuuu_tpu/ops/pallas/decode_attn.py).

The T=1 step of LM generation: the single new token's queries ``q
[B, H, D]`` attend the cached keys ``0..lengths[b]`` of their row (the new
token's K/V already written at ``lengths[b]``), and the output is fp32
``[B, H, D]``, the contract of the dense region it replaces
(``lm/generate.CachedAttention``). On a CUDA tensor the kernel
(``csrc/decode_attn.cu``) runs, adding one to ``launches``, or the call
raises; on a CPU tensor :func:`decode_attention_plain` runs: the dense
fp32 einsum, mask at −1e30, softmax and einsum of the JAX reference (a
row with no visible key gives 0, as the TPU kernel's empty loop does).

:func:`supported` and :func:`resolve_block` are the JAX module's, so the
same ``(cache tile, KERNELS.DECODE_BLOCK)`` pairs take the kernel as on
the TPU. The CUDA kernel itself does not tile by the block. Its Hopper
body (``decode_split``) spreads each row's live keys over a cluster of
``splits`` blocks (:func:`split_range`), feeds each block's keys into a
shared-memory ring with bulk async copies and merges the blocks' softmax
states inside the cluster, one launch a call; the tiling is :func:`plan`.
A call whose head dim is not a whole number of 16-byte pieces, or whose
q, K or V base is not 16-byte aligned, runs the first design
(``decode_simple``, one block per ``(b, h)``); :func:`kernel_body` says
which.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distribuuuu_tpu_torch.ops import cuda as kernel_tier

# default cache-block height of the TPU kernel (KERNELS.DECODE_BLOCK)
BLK_K = 128
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reset_launch_counts() -> None:
    global launches
    launches = 0


def resolve_block(cache_len: int, blk: int) -> int | None:
    """The key-block height used for a cache tile: ``blk`` when it divides
    the tile, the whole tile when it fits inside one block, else None."""
    if cache_len <= blk:
        return cache_len
    if cache_len % blk == 0:
        return blk
    return None


def supported(t: int, cache_len: int, head_dim: int, blk: int) -> tuple[bool, str]:
    """(supported, reason) for one cached-attention call site."""
    if t != 1:
        return False, f"T={t} new tokens (the kernel is the T=1 decode step)"
    if head_dim > MAX_HEAD_DIM:
        return False, f"head_dim {head_dim} > {MAX_HEAD_DIM} (lane tiling)"
    if resolve_block(cache_len, blk) is None:
        return False, (
            f"KERNELS.DECODE_BLOCK={blk} does not divide the cache tile "
            f"{cache_len} ({cache_len} % {blk} = {cache_len % blk})"
        )
    return True, ""


def decode_attention_plain(q, cache_k, cache_v, lengths, scale: float) -> torch.Tensor:
    """The dense fp32 T=1 step: ``softmax((q·K)·scale, keys ≤ length)·V``."""
    c = cache_k.shape[2]
    s = torch.einsum("bhd,bhcd->bhc", q.float(), cache_k.float()) * scale
    kpos = torch.arange(c, device=q.device)
    vis = kpos[None, None, :] <= lengths.to(q.device).long()[:, None, None]
    s = torch.where(vis, s, -1e30)
    w = torch.where(vis, torch.softmax(s, dim=-1), 0.0)  # no visible key: 0
    return torch.einsum("bhc,bhcd->bhd", w, cache_v.float())


# ---------------------------------------------------------------------------
# the Hopper body's tiling
# ---------------------------------------------------------------------------

WARPS = 4  # a block of either body
MAX_SPLITS = 8  # the portable cluster size
PLAN_STAGES = 2  # the deepest ring a plan takes
BLOCK_BYTES = 16384  # K and V a block takes of a full row (where 8 splits allow)
STAGE_BYTES = 16384  # K and V of one ring stage, about
MAX_RING = 200 * 1024  # the launcher's limit on the ring's bytes


class DecodePlan(NamedTuple):
    """The tiling of one call: ``body`` ``split`` (the cluster design) or
    ``simple`` (the first design, which takes no tiling); ``splits`` blocks
    a cluster, each taking ``split_range`` of a row's live keys; a ring of
    ``stages`` stages of ``stage_keys`` keys."""

    body: str
    splits: int
    stage_keys: int
    stages: int


def key_groups(d: int, dtype: torch.dtype) -> int:
    """Groups of lanes a block of the split body runs, each on its own keys:
    a key row of the head dim rounded up to 32, 64 or 128 is read 16 bytes
    a lane."""
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    lanes_per_key = dp * dtype.itemsize // 16
    return WARPS * (32 // lanes_per_key)


def split_range(n: int, splits: int, rank: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` of a row with ``n`` live keys that block ``rank``
    of its cluster takes (the kernel's own arithmetic)."""
    kpb = -(-n // splits)
    lo = min(n, rank * kpb)
    return lo, min(n, lo + kpb)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, c: int, d: int, dtype: torch.dtype) -> DecodePlan:
    """The tiling for a ``[b, h, c, d]`` cache of ``dtype``; shapes alone.
    The simple body where a key row is not a whole number of 16-byte
    pieces. Else (``decode_sweep.py`` on the H100): enough blocks a row
    that a block takes about BLOCK_BYTES of a full row's K and V, capped at
    8 and so that a block of a full row has a key for every key group; a
    block's keys in one stage where they fit in STAGE_BYTES, else a ring of
    two stages of about STAGE_BYTES, whole key groups each. The batch and head
    counts do not enter: at 16 to 128 rows of 256 keys the sweep puts the
    fastest tilings within 0.3 us of one another."""
    esz = dtype.itemsize
    if (d * esz) % 16:
        return DecodePlan("simple", 1, 0, 0)
    ng = key_groups(d, dtype)
    row = 2 * d * esz
    splits = max(1, min(MAX_SPLITS, -(-c * row // BLOCK_BYTES), -(-c // ng)))
    keys = -(-c // splits)
    stage_keys = min(-(-keys // ng) * ng, max(ng, STAGE_BYTES // row // ng * ng))
    stages = min(PLAN_STAGES, -(-keys // stage_keys))
    return DecodePlan("split", splits, stage_keys, stages)


def ring_bytes(tiling: DecodePlan, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a split launch: the ring, a barrier a stage."""
    return tiling.stages * (2 * tiling.stage_keys * d * dtype.itemsize + 8)


def kernel_body(q, cache_k, cache_v) -> str:
    """The body the launcher runs for this call on the card: ``split``
    (the plan's, with 16-byte aligned q, K and V) or ``simple``."""
    b, h, c, d = cache_k.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, cache_k, cache_v))
    return "split" if aligned and plan(b, h, c, d, q.dtype).body == "split" else "simple"


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("decode_attn")
    if lib.decode_simple_launch.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, lengths, out, B, H, C, D, dtype, scale, vec_ok, stream
        lib.decode_simple_launch.argtypes = [vp] * 5 + [i] * 5 + [f, i, vp]
        # ..., scale, splits, stage_keys, stages, stream
        lib.decode_split_launch.argtypes = [vp] * 5 + [i] * 5 + [f, i, i, i, vp]
        lib.decode_floor_launch.argtypes = [i, i, i, vp]  # B, H, splits, stream
        for fn in (lib.decode_simple_launch, lib.decode_split_launch, lib.decode_floor_launch):
            fn.restype = ctypes.c_int
    return lib


def _check(q, cache_k, cache_v, lengths) -> None:
    """What the kernel takes: q [B, H, D], K/V [B, H, C, D] contiguous, one
    dtype of f32/bf16, D ≤ 128, lengths int32 [B], all on one CUDA device."""
    if cache_k.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention kernel takes f32 or bf16, not {cache_k.dtype}")
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"decode_attention: cache K {tuple(cache_k.shape)} and V "
                         f"{tuple(cache_v.shape)} must be one [B, H, C, D] shape")
    b, h, _, d = cache_k.shape
    if tuple(q.shape) != (b, h, d) or q.dtype != cache_k.dtype or cache_v.dtype != q.dtype:
        raise ValueError(f"decode_attention: q {q.dtype} {tuple(q.shape)} against a cache of "
                         f"{cache_k.dtype} {tuple(cache_k.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel: head dim {d} > {MAX_HEAD_DIM}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise TypeError(f"decode_attention: lengths {lengths.dtype} {tuple(lengths.shape)}, "
                        f"want int32 ({b},)")
    for t in (cache_k, cache_v, lengths):
        if t.device != q.device:
            raise ValueError(f"decode_attention: operands on {t.device} and {q.device}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("decode_attention kernel reads contiguous cache pages")


def decode_attention_kernel(q, cache_k, cache_v, lengths, scale: float,
                            tiling: DecodePlan | None = None) -> torch.Tensor:
    """The kernel on CUDA tensors; returns fp32 [B, H, D]. ``tiling``
    (default :func:`plan`) is for the sweep and the tests; its body
    ``simple`` runs the first design."""
    global launches
    q = q.contiguous()
    lengths = lengths.contiguous()
    _check(q, cache_k, cache_v, lengths)
    b, h, c, d = cache_k.shape
    p = tiling or plan(b, h, c, d, q.dtype)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, cache_k, cache_v))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, h, c, d, _DTYPE_CODE[q.dtype], float(scale))
        if p.body == "split" and aligned:
            err = lib.decode_split_launch(*ptrs, p.splits, p.stage_keys, p.stages, stream)
        else:
            vec_ok = d % (16 // q.element_size()) == 0 and aligned
            err = lib.decode_simple_launch(*ptrs, int(vec_ok), stream)
    if err != 0:
        raise RuntimeError(f"decode attention launch ({p}) failed: CUDA error {err}")
    launches += 1
    return out


def launch_floor(device, b: int, h: int, splits: int = 1) -> None:
    """An empty kernel over the split body's grid (splits, h, b) in clusters
    of ``splits`` (1, 1, 1: one empty block): the launch floor a timing
    stands on. Counts no launch."""
    with torch.cuda.device(device):
        err = _lib().decode_floor_launch(b, h, splits,
                                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_floor_launch failed: CUDA error {err}")


def decode_attention(q, cache_k, cache_v, lengths, *, scale: float,
                     blk_k: int = BLK_K) -> torch.Tensor:
    """One decode-attention step. q: [B, H, D]; cache_k/cache_v: [B, H, C, D]
    (row b's positions 0..lengths[b] live, the new token's K/V written at
    lengths[b]); lengths: [B] int32. Returns fp32 [B, H, D]."""
    c = cache_k.shape[2]
    if resolve_block(c, blk_k) is None:
        raise ValueError(f"decode_attention: block {blk_k} does not divide cache {c}")
    if kernel_tier.choose(q, "decode_attn"):
        return decode_attention_kernel(q, cache_k, cache_v, lengths, scale)
    return decode_attention_plain(q, cache_k, cache_v, lengths, scale)


def pass_bytes(b: int, h: int, c: int, d: int, cache_dtype: torch.dtype) -> int:
    """The TPU kernel's DMA model of one step over the whole tile: K and V
    pages read once in their stored dtype, q read and out written once."""
    csz = torch.empty((), dtype=cache_dtype).element_size()
    return 2 * b * h * c * d * csz + b * h * d * csz + b * h * d * 4 + b * 4


def live_bytes(lengths, h: int, c: int, d: int, cache_dtype: torch.dtype) -> int:
    """The bytes one step must move for these lengths: the live K and V
    rows (``min(len + 1, C)`` a row) read once, q and lengths read once,
    the fp32 out written once."""
    csz = torch.empty((), dtype=cache_dtype).element_size()
    live = sum(max(0, min(int(n) + 1, c)) for n in lengths)
    b = len(lengths)
    return 2 * h * d * csz * live + b * h * d * (csz + 4) + 4 * b
