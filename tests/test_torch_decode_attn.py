"""The decode-attention kernel's plain version (ops/cuda/decode_attn.py)
against the JAX package's Pallas kernel in interpret mode, on the same
numpy-seeded inputs; its tile rules against JAX's; and the CPU routing of
the wrapper. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distribuuuu_tpu.ops.pallas import decode_attn as jda
from distribuuuu_tpu_torch.ops.cuda import decode_attn as tda

# f32 summation order (online softmax vs dense); the bf16 inputs are cast to
# fp32 by both before any arithmetic, so bf16 holds the same tolerance (as
# tests/test_pallas_kernels.py pins the Pallas kernel against the dense step)
TOL = 1e-5


def _inputs(b, h, c, d, lengths, dtype, seed=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, d), (b, h, c, d), (b, h, c, d)))
    if dtype == "bfloat16":  # round once, give both sides the same values
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                   for x in (q, k, v))
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,c,d,lengths", [
    (3, 2, 256, 32, [0, 100, 255]),   # fresh / mid / full rows, two blocks
    (3, 2, 96, 32, [0, 50, 95]),      # a tile inside one block (C < 128)
    (2, 2, 256, 128, [7, 255]),       # the widest head dim
])
def test_plain_matches_pallas_interpret(dtype, b, h, c, d, lengths):
    q, k, v, lens = _inputs(b, h, c, d, lengths, dtype)
    scale = d ** -0.5
    jdt = getattr(jnp, dtype)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lens), scale=scale, interpret=True))
    tdt = getattr(torch, dtype)
    got = tda.decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(lens), scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("c", [16, 96, 128, 200, 256, 384])
@pytest.mark.parametrize("d,blk", [(32, 128), (64, 64), (128, 96), (160, 128)])
def test_tile_rules_match_jax(t, c, d, blk):
    assert tda.resolve_block(c, blk) == jda.resolve_block(c, blk)
    assert tda.supported(t, c, d, blk) == jda.supported(t, c, d, blk)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 32, [3, 63], "float32"))
    tda.reset_launch_counts()
    got = tda.decode_attention(q, k, v, lens, scale=0.25)
    assert tda.launches == 0
    torch.testing.assert_close(got, tda.decode_attention_plain(q, k, v, lens, 0.25),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        tda.decode_attention(q, k, v, lens, scale=0.25, blk_k=48)


def test_other_devices_raise():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 32, [3, 63], "float32"))
    with pytest.raises(RuntimeError, match="no kernel or plain version"):
        tda.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), lens.to("meta"),
                             scale=0.25)


def test_byte_models():
    b, h, c, d = 4, 4, 256, 32
    assert tda.pass_bytes(b, h, c, d, torch.bfloat16) == jda.pass_bytes(b, h, c, d, jnp.bfloat16)
    # live rows only: lengths 0, 37, 128, 255 read 1 + 38 + 129 + 256 keys
    live = tda.live_bytes([0, 37, 128, 255], h, c, d, torch.bfloat16)
    assert live == 2 * h * d * 2 * 424 + b * h * d * (2 + 4) + 4 * b
    assert tda.live_bytes([c - 1] * b, h, c, d, torch.bfloat16) == tda.pass_bytes(
        b, h, c, d, torch.bfloat16)
