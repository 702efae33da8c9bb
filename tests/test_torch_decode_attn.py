"""The decode-attention kernel's plain version (ops/cuda/decode_attn.py)
against the JAX package's Pallas kernel in interpret mode, on the same
numpy-seeded inputs; its tile rules against JAX's; the Hopper body's
tiling (``plan``, ``split_range``) and, written here in PyTorch, its
cluster combine (per-split softmax states merged in rank order) against
the Pallas kernel; and the CPU routing of the wrapper. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

from __future__ import annotations

import inspect

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


def test_plain_gives_zero_without_a_visible_key_as_pallas():
    """Length −1 leaves no visible key: the Pallas kernel's loop runs no
    block and writes 0, and so does the plain version (not the mean of V
    that a softmax over masked scores would give); a length past C sees
    all C keys in both."""
    b, h, c, d = 3, 2, 64, 32
    q, k, v, lens = _inputs(b, h, c, d, [-1, 0, c + 5], "float32")
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale=d ** -0.5, interpret=True))
    got = tda.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, lens)),
                                     d ** -0.5)
    assert not want[0].any() and not got[0].numpy().any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# (b, h, c, d, dtype) the plan is pinned at: the GPT-nano batch and cache
# tiles, the TPU bench shape, the bandwidth probe, f32, ragged caches and
# head dims whose rows are not whole 16-byte pieces (33, 100 bf16; 30 f32)
PLAN_SHAPES = [
    *[(bt, 4, ct, 32, torch.bfloat16) for bt in (1, 2, 4, 8, 16, 32) for ct in (32, 64, 128, 256)],
    (4, 6, 256, 64, torch.bfloat16),
    (8, 16, 4096, 128, torch.bfloat16),
    (3, 2, 96, 32, torch.float32),
    (5, 3, 2000, 128, torch.float32),
    (2, 2, 300, 48, torch.bfloat16),
    (1, 1, 7, 64, torch.bfloat16),
    (64, 16, 1024, 64, torch.bfloat16),
    (2, 2, 96, 33, torch.bfloat16),
    (2, 2, 96, 100, torch.bfloat16),
    (2, 2, 96, 30, torch.float32),
]
SMEM = 232448  # shared memory a block may use on the H100
STATIC_SMEM = 6272  # the split body's merge arrays at head dim 128 (ptxas -v), the most


@pytest.mark.parametrize("b,h,c,d,dtype", PLAN_SHAPES, ids=str)
def test_plan_covers_the_cache_and_fits(b, h, c, d, dtype):
    p = tda.plan(b, h, c, d, dtype)
    bulk = (d * dtype.itemsize) % 16 == 0
    assert (p.body == "split") == bulk  # the first design exactly where a row is not whole pieces
    if not bulk:
        return
    assert 1 <= p.splits <= 8
    keys = -(-c // p.splits)  # the most keys a block takes
    assert (p.splits - 1) * keys < c <= p.splits * keys
    for n in {0, 1, c // 3, c - 1, c}:  # a row's live keys: split in rank order, no gap or overlap
        spans = [tda.split_range(n, p.splits, r) for r in range(p.splits)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(spans[r][1] == spans[r + 1][0] for r in range(p.splits - 1))
        assert all(hi - lo <= keys for lo, hi in spans)
    assert p.stage_keys % tda.key_groups(d, dtype) == 0
    assert (p.stage_keys * d * dtype.itemsize) % 16 == 0 and (d * dtype.itemsize) % 16 == 0
    assert 1 <= p.stages <= tda.PLAN_STAGES and (p.stages - 1) * p.stage_keys < keys
    assert tda.ring_bytes(p, d, dtype) <= tda.MAX_RING
    assert tda.ring_bytes(p, d, dtype) + STATIC_SMEM <= SMEM


def test_plan_reads_shapes_alone():
    assert list(inspect.signature(tda.plan).parameters) == ["b", "h", "c", "d", "dtype"]
    first = [tda.plan(*s) for s in PLAN_SHAPES]
    tda.plan.cache_clear()
    assert [tda.plan(*s) for s in PLAN_SHAPES] == first
    assert tda.plan.cache_info().hits == 0
    tda.plan(*PLAN_SHAPES[0])
    assert tda.plan.cache_info().hits == 1


def test_plan_at_the_swept_shapes():
    """The tilings the sweep found fastest (or within 0.3 us of it) at
    chip_smoke's decode shapes."""
    nano = tda.DecodePlan("split", 2, 128, 1)  # two blocks of 128 keys a row, one stage each
    assert tda.plan(4, 4, 256, 32, torch.bfloat16) == nano
    assert tda.plan(32, 4, 256, 32, torch.bfloat16) == nano
    assert tda.plan(4, 6, 256, 64, torch.bfloat16) == tda.DecodePlan("split", 4, 64, 1)
    assert tda.plan(8, 16, 4096, 128, torch.bfloat16) == tda.DecodePlan("split", 8, 32, 2)
    assert tda.plan(3, 2, 96, 32, torch.float32) == tda.DecodePlan("split", 2, 48, 1)


@pytest.mark.parametrize("splits", range(1, 9))
def test_split_range_partitions_every_length(splits):
    for n in range(0, 70):
        spans = [tda.split_range(n, splits, r) for r in range(splits)]
        keys = [j for lo, hi in spans for j in range(lo, hi)]
        assert keys == list(range(n))


def test_kernel_body_follows_alignment_and_plan():
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(2, 2, 64, 32, [3, 63], "float32"))
    assert tda.kernel_body(q, k, v) == "split"
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape).copy_(k)
    assert tda.kernel_body(q, shifted, v) == "simple"
    q33, k33, v33, _ = (torch.from_numpy(x).to(torch.bfloat16)
                        for x in _inputs(2, 2, 64, 33, [3, 63], "float32"))
    assert tda.kernel_body(q33, k33, v33) == "simple"


NEG_BIG = -0.7 * np.finfo(np.float32).max  # the kernel's empty-state m
LOG2E = 1.4426950408889634


def _split_states(q, k, v, lens, scale, splits):
    """Each block's (m, l, acc) as the split body leaves it, in the exp2
    domain: block r of a row takes ``split_range`` of its live keys; a
    block with none keeps (−big, 0, 0)."""
    b, h, c, d = k.shape
    s2 = torch.einsum("bhd,bhcd->bhc", q, k) * (scale * LOG2E)
    states = []
    for r in range(splits):
        m = torch.full((b, h), NEG_BIG)
        l = torch.zeros(b, h)
        acc = torch.zeros(b, h, d)
        for i in range(b):
            lo, hi = tda.split_range(max(0, min(int(lens[i]) + 1, c)), splits, r)
            if hi > lo:
                m[i] = s2[i, :, lo:hi].max(-1).values
                p = torch.exp2(s2[i, :, lo:hi] - m[i][:, None])
                l[i] = p.sum(-1)
                acc[i] = torch.einsum("hc,hcd->hd", p, v[i, :, lo:hi])
        states.append((m, l, acc))
    return states


def _merge_in_rank_order(states):
    """The cluster's combine: rank 0 merges every rank's state in order."""
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        c = torch.exp2(m - mx)
        lsum = lsum + l * c
        acc = acc + a * c[..., None]
    return acc / torch.clamp(lsum, min=1e-30)[..., None]


@pytest.fixture(scope="module")
def pallas_reference():
    """The Pallas kernel in interpret mode at a small tile, lengths −1, 0,
    1, C − 1 and past C."""
    b, h, c, d = 5, 2, 64, 32
    q, k, v, lens = _inputs(b, h, c, d, [-1, 0, 1, c - 1, c + 5], "float32", seed=11)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale=d ** -0.5, interpret=True))
    return (q, k, v, lens), want


@pytest.mark.parametrize("splits", range(1, tda.MAX_SPLITS + 1))
def test_rank_order_merge_matches_pallas_at_every_planned_split(pallas_reference, splits):
    """Every cluster size a plan may pick (1 to 8; PLAN_SHAPES give 1, 2, 4
    and 8)."""
    (q, k, v, lens), want = pallas_reference
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    states = _split_states(tq, tk, tv, lens, q.shape[-1] ** -0.5, splits)
    if splits > 1:  # the row of one key leaves every block but rank 0 empty
        assert all(float(l[1].max()) == 0.0 for _, l, _ in states[1:])
    got = _merge_in_rank_order(states)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_byte_models():
    b, h, c, d = 4, 4, 256, 32
    assert tda.pass_bytes(b, h, c, d, torch.bfloat16) == jda.pass_bytes(b, h, c, d, jnp.bfloat16)
    # live rows only: lengths 0, 37, 128, 255 read 1 + 38 + 129 + 256 keys
    live = tda.live_bytes([0, 37, 128, 255], h, c, d, torch.bfloat16)
    assert live == 2 * h * d * 2 * 424 + b * h * d * (2 + 4) + 4 * b
    assert tda.live_bytes([c - 1] * b, h, c, d, torch.bfloat16) == tda.pass_bytes(
        b, h, c, d, torch.bfloat16)
