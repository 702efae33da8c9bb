"""Decode attention over the paged KV cache (counterpart of
distribuuuu_tpu/ops/pallas/decode_attn.py).

The T=1 step of LM generation: the single new token's queries ``q
[B, H, D]`` attend the cached keys ``0..lengths[b]`` of their row (the new
token's K/V already written at ``lengths[b]``), and the output is fp32
``[B, H, D]``, the contract of the dense region it replaces
(``lm/generate.CachedAttention``). On a CUDA tensor the kernel
(``csrc/decode_attn.cu``) runs, adding one to ``launches``, or the call
raises; on a CPU tensor :func:`decode_attention_plain` runs: the dense
fp32 einsum, mask at −1e30, softmax and einsum of the JAX reference.

:func:`supported` and :func:`resolve_block` are the JAX module's, so the
same ``(cache tile, KERNELS.DECODE_BLOCK)`` pairs take the kernel as on
the TPU. The CUDA kernel itself does not tile by the block: one block of
threads per ``(b, h)`` streams the live keys.
"""

from __future__ import annotations

import ctypes

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
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhc,bhcd->bhd", w, cache_v.float())


def _lib():
    from distribuuuu_tpu_torch.ops.cuda import _build

    lib = _build.load("decode_attn")
    if lib.decode_attn_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, lengths, out, B, H, C, D, dtype, scale, vec_ok, stream
        lib.decode_attn_launch.argtypes = [vp] * 5 + [i] * 5 + [ctypes.c_float, i, vp]
        lib.decode_attn_launch.restype = ctypes.c_int
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


def decode_attention_kernel(q, cache_k, cache_v, lengths, scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors; returns fp32 [B, H, D]."""
    global launches
    q = q.contiguous()
    lengths = lengths.contiguous()
    _check(q, cache_k, cache_v, lengths)
    b, h, c, d = cache_k.shape
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    vec = 16 // q.element_size()
    vec_ok = d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (q, cache_k, cache_v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().decode_attn_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, c, d, _DTYPE_CODE[q.dtype], float(scale), int(vec_ok), stream)
    if err != 0:
        raise RuntimeError(f"decode_attn_launch failed: CUDA error {err}")
    launches += 1
    return out


def decode_attention(q, cache_k, cache_v, lengths, *, scale: float,
                     blk_k: int = BLK_K) -> torch.Tensor:
    """One decode-attention step. q: [B, H, D]; cache_k/cache_v: [B, H, C, D]
    (row b's positions 0..lengths[b] live, the new token's K/V written at
    lengths[b]); lengths: [B] int32. Returns fp32 [B, H, D]."""
    c = cache_k.shape[2]
    if resolve_block(c, blk_k) is None:
        raise ValueError(f"decode_attention: block {blk_k} does not divide cache {c}")
    if kernel_tier.use_kernel(q):
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
