"""The port's flash attention (distribuuuu_tpu_torch/ops/cuda/flash_attention.py)
and single-device attention (ops/ring_attention.py) against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernels in the interpreter
(``interpret=True``, blocks of 256), as tests/test_flash_attention.py
does; the port's side runs the kernels' plain versions (CPU tensors),
through the same autograd Function the card uses. Inputs are made with
numpy from a seed. f32 throughout: the forward and the log-sum-exp agree
to 2e-5 absolute, the gradients to 5e-5 (the two sum in different orders:
the interpreter over 256-key blocks, the port over 64-key tiles and dense
backward products), causal and padded lengths included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads

from distribuuuu_tpu.models.vit import Attention as JAttention
from distribuuuu_tpu.ops import flash_attention as jfa
from distribuuuu_tpu.ops import ring_attention as jra
from distribuuuu_tpu_torch.models.vit import Attention as TAttention
from distribuuuu_tpu_torch.ops import ring_attention as tra
from distribuuuu_tpu_torch.ops.cuda import flash_attention as tfa

BLK = dict(blk_q=256, blk_k=256)
SHAPES = [(2, 3, 512, 64), (1, 2, 300, 64), (2, 2, 640, 32)]


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_lse_match_jax_interpret(shape, causal):
    arrs = _inputs(shape, 0)
    jo, jlse = jfa.flash_attention_with_lse(*map(jnp.asarray, arrs), causal=causal,
                                            interpret=True, **BLK)
    with torch.no_grad():
        to, tlse = tfa.flash_attention_with_lse(*_t(arrs), causal=causal)
        plain = tfa.flash_attention(*_t(arrs), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5)
    assert torch.equal(plain, to)
    assert tfa.launch_counts() == {"forward": 0, "dq": 0, "dkdv": 0}  # CPU: plain versions


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [512, 300])
def test_gradients_match_jax_interpret(L, causal):
    arrs = _inputs((1, 2, L, 64), 1)
    w = np.random.default_rng(2).standard_normal((64,)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal, interpret=True, **BLK) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    q, k, v = _t(arrs, grad=True)
    loss = (tfa.flash_attention(q, k, v, causal=causal) * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(loss, (q, k, v))
    for a, b, name in zip(tg, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=name)


def test_lse_cotangent_folds_into_delta_as_in_jax():
    """Both outputs of flash_attention_with_lse carry a cotangent (the
    ring attention's use): dQ/dK/dV as JAX's vjp, L padded, causal."""
    arrs = _inputs((1, 2, 300, 64), 3)
    rng = np.random.default_rng(4)
    w, u = rng.standard_normal((64,)).astype(np.float32), \
        rng.standard_normal((1, 2, 300)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=True, interpret=True, **BLK)
        return jnp.sum(o * w) + jnp.sum(lse * u)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    q, k, v = _t(arrs, grad=True)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    loss = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(u)).sum()
    for a, b, name in zip(torch.autograd.grad(loss, (q, k, v)), jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_and_reference_match_jax(causal):
    """The plain-torch single-device attention against JAX's (L = 300 over
    chunks of 128: a padded, masked last chunk), forward and gradients."""
    arrs = _inputs((2, 2, 300, 32), 5)
    w = np.random.default_rng(6).standard_normal((32,)).astype(np.float32)
    for jfn, tfn, kw in ((jra.blockwise_attention, tra.blockwise_attention, {"chunk": 128}),
                         (jra.reference_attention, tra.reference_attention, {})):
        def jloss(q, k, v, jfn=jfn, kw=kw):
            return jnp.sum(jfn(q, k, v, causal=causal, **kw) * w)

        jout = jfn(*map(jnp.asarray, arrs), causal=causal, **kw)
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
        q, k, v = _t(arrs, grad=True)
        out = tfn(q, k, v, causal=causal, **kw)
        tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (q, k, v))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)


def test_bf16_plain_forward_rounds_where_the_pallas_body_does():
    """bf16 inputs: p is rounded to bf16 before p·V on both sides. The
    online-softmax tiles differ (256 keys in the interpreter, 64 here), so
    the rounded p differ by up to one bf16 ulp: agreement to 2e-2."""
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, _inputs((1, 2, 300, 64), 7))]
    jo = jfa.flash_attention(*arrs, interpret=True, **BLK)
    with torch.no_grad():
        to = tfa.flash_attention(*(torch.from_numpy(np.array(a.astype(jnp.float32)))
                                   .bfloat16() for a in arrs))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("seq_len,dropout", [(1023, 0.0), (1024, 0.0), (4096, 0.0),
                                             (4096, 0.1), (196, 0.0)])
def test_resolve_impl_threshold_matches_jax(seq_len, dropout):
    for impl in ("auto", "xla", "flash", "blockwise"):
        assert TAttention.resolve_impl(impl, seq_len, dropout) == \
            JAttention.resolve_impl(impl, seq_len, dropout)
    assert TAttention.FLASH_MIN_SEQ == JAttention.FLASH_MIN_SEQ == 1024


def test_refusals():
    q = torch.zeros(1, 1, 8, 160)
    with pytest.raises(ValueError, match="head_dim 160 > 128"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one \\[B, H, L, D\\] shape"):
        tfa.flash_attention(torch.zeros(1, 1, 8, 64), torch.zeros(1, 1, 9, 64),
                            torch.zeros(1, 1, 8, 64))
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tra.ring_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tra.ulysses_attention(q, q, q)
    assert [tfa.padded_head_dim(d) for d in (8, 32, 40, 64, 65, 128)] == \
        [32, 32, 64, 64, 128, 128]


def test_kernel_accounting():
    """The bytes and operations chip_smoke.py's bounds are built from."""
    b = tfa.pass_bytes(192, 196, 64, torch.bfloat16)
    t = 192 * 196 * 64 * 2
    assert b == {"forward": 4 * t + 192 * 196 * 4, "dq": 5 * t + 2 * 192 * 196 * 4,
                 "dkdv": 6 * t + 2 * 192 * 196 * 4}
    f = tfa.flops(12, 4096, 64)
    assert f["forward"] == 4 * 12 * 4096 ** 2 * 64 and f["dkdv"] == 2 * f["forward"]
    assert tfa.flops(1, 4, 8, causal=True)["forward"] == 4 * 10 * 8


# ---- the backward's body and tiling (pure functions: pinned here, run on the card)

# (L, d) that the ViT and GPT configs and chip_smoke.py's FLASH_SHAPES reach:
# ViT-Ti/S at 224² (196 tokens) and 1024² (4096), GPT-nano's 256, head dims
# 32/64/128, ragged lengths
PLAN_SHAPES = [(L, d) for L in (196, 4096, 150, 197, 4097, 70, 1100, 256)
               for d in (32, 64, 128)]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_bwd_body_is_chosen_by_dtype_and_head_dim(d):
    """bf16/f16 run the wgmma bodies at 64 and 128, a head dim of 32 padded
    to 64 for them; f32 runs its own bodies at its own head dim."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.kernel_head_dim(dtype, d) == max(d, 64)
        assert tfa.kernel_body(dtype, tfa.kernel_head_dim(dtype, d)) == "wgmma"
        if d == 32:
            with pytest.raises(ValueError, match="head dims"):
                tfa.kernel_body(dtype, d)
    assert tfa.kernel_head_dim(torch.float32, d) == d
    assert tfa.kernel_body(torch.float32, d) == "f32"
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        db = tfa.kernel_head_dim(dtype, d)
        assert tfa.bwd_plan(196, db, dtype).body == tfa.kernel_body(dtype, db)


def _fake_launchers(monkeypatch, scales=None):
    """Stand-ins for the C entry points (the card runs them): each call is
    recorded as (entry point, L, d, dtype, causal, plan), and its scale in
    ``scales`` if given; the launch counters are restored after the test."""
    calls = []
    for counter in ("fwd_launches", "dq_launches", "dkdv_launches"):
        monkeypatch.setattr(tfa, counter, getattr(tfa, counter))
    monkeypatch.setattr(tfa, "_lib", lambda: type("Lib", (), {
        "flash_fwd_launch": "fwd", "flash_dq_launch": "dq", "flash_dkdv_launch": "dkdv"}))

    def call(fn, name, *ptrs, plan=(), **kw):
        calls.append((fn, kw["L"], kw["d"], kw["dtype"], kw["causal"], tuple(plan)))
        if scales is not None:
            scales.append(kw["scale"])

    monkeypatch.setattr(tfa, "_call", call)
    return calls


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("L,d", PLAN_SHAPES, ids=lambda v: str(v))
def test_bwd_plan_is_legal(monkeypatch, L, d, dtype, causal):
    """At the backward's head dim for ``d``, the wgmma bodies' plan is a
    dK/dV query tile the kernel is built for (32, or 64 at d 64) and a
    ring of 1..4 stages, no more than the sequence has tiles; the f32 body
    takes none. The wrappers hand it, and ``causal``, to the entry points
    (the launcher checks the plan's shared memory on the card)."""
    db = tfa.kernel_head_dim(dtype, d)
    p = tfa.bwd_plan(L, db, dtype)
    if p.body == "f32":
        assert p[1:] == (0, 0)
    else:
        assert p.dkdv_bq in ((32, 64) if db == 64 else (32,))
        assert 1 <= p.dkdv_stages <= min(4, -(-L // p.dkdv_bq))
    calls = _fake_launchers(monkeypatch)
    q = torch.zeros(1, L, db, dtype=dtype)
    lse = torch.zeros(1, L)
    tfa.dq_kernel(q, q, q, q, lse, lse, 0.125, causal)
    tfa.dkdv_kernel(q, q, q, q, lse, lse, 0.125, causal)
    assert calls == [("dq", L, db, dtype, causal, ()),
                     ("dkdv", L, db, dtype, causal, (p.dkdv_bq, p.dkdv_stages))]


@pytest.mark.parametrize("L,causal,want", [
    (196, False, tfa.BwdPlan("wgmma", 32, 4)),  # ViT-S train [192, 196, 64]
    (196, True, tfa.BwdPlan("wgmma", 32, 4)),
    (4096, False, tfa.BwdPlan("wgmma", 64, 2)),  # ViT-Ti at 1024² [12, 4096, 64]
    (4096, True, tfa.BwdPlan("wgmma", 64, 2)),
])
def test_bwd_plan_pins_the_main_shapes(monkeypatch, L, causal, want):
    """The plan at the main path's shapes, and the one the dK/dV wrapper
    passes there, causal or not."""
    assert tfa.bwd_plan(L, 64, torch.bfloat16) == want
    calls = _fake_launchers(monkeypatch)
    q = torch.zeros(1, L, 64, dtype=torch.bfloat16)
    tfa.dkdv_kernel(q, q, q, q, torch.zeros(1, L), torch.zeros(1, L), 0.125, causal)
    assert calls == [("dkdv", L, 64, torch.bfloat16, causal, want[1:])]


def test_bwd_plan_is_cached_per_shape():
    tfa.bwd_plan.cache_clear()
    first = tfa.bwd_plan(196, 64, torch.bfloat16)
    assert tfa.bwd_plan(196, 64, torch.bfloat16) is first
    assert tfa.bwd_plan.cache_info().hits == 1


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float16, 128),
                                     (torch.bfloat16, 32), (torch.float32, 64)])
def test_backward_wrappers_pass_the_plan_to_the_launchers(monkeypatch, dtype, d):
    """dq_kernel and dkdv_kernel hand the entry points dK/dV's tiling
    (bq, stages) and count one launch each; a 16-bit head dim the wgmma
    bodies are not built for raises before any launch. The launch itself
    is stood in for here (the card runs it)."""
    calls = _fake_launchers(monkeypatch)
    q = torch.zeros(2, 197, d, dtype=dtype)
    lse, delta = torch.zeros(2, 197), torch.zeros(2, 197)
    before = tfa.launch_counts()
    if d not in tfa.WGMMA_HEAD_DIMS and dtype != torch.float32:
        for kernel in (tfa.dq_kernel, tfa.dkdv_kernel):
            with pytest.raises(ValueError, match="head dims"):
                kernel(q, q, q, q, lse, delta, 0.125, True)
        assert calls == [] and tfa.launch_counts() == before
        q = torch.zeros(2, 197, tfa.kernel_head_dim(dtype, d), dtype=dtype)
    tfa.dq_kernel(q, q, q, q, lse, delta, 0.125, True)
    tfa.dkdv_kernel(q, q, q, q, lse, delta, 0.125, True)
    db = q.shape[-1]
    p = tfa.bwd_plan(197, db, dtype)
    assert calls == [("dq", 197, db, dtype, True, ()),
                     ("dkdv", 197, db, dtype, True, (p.dkdv_bq, p.dkdv_stages))]
    assert tfa.launch_counts() == {**before, "dq": before["dq"] + 1,
                                   "dkdv": before["dkdv"] + 1}


@pytest.mark.parametrize("d", [24, 32])
def test_backward_pads_a_small_16bit_head_dim_to_the_wgmma_bodies(monkeypatch, d):
    """On the card the autograd Function runs a bf16 backward of head dim
    ≤ 32 at 64: zero columns, which change no gradient. Stood in for on
    the CPU: the kernel wrappers are the plain versions, with the head dim
    they are handed recorded; the gradients equal the unpadded run's to
    a bf16 ulp of their scale (the fp32 sums may block differently)."""
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((1, 2, 40, d)).astype(np.float32) for _ in range(4)]

    def grads():
        q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in arrs[:3])
        o = tfa.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad((o.float() * torch.tensor(arrs[3])).sum(), (q, k, v))

    want = grads()
    seen = []
    monkeypatch.setattr(tfa.kernel_tier, "use_kernel", lambda t: True)
    monkeypatch.setattr(tfa, "forward_kernel", tfa.forward_plain)
    for name, plain in (("dq_kernel", tfa.dq_plain), ("dkdv_kernel", tfa.dkdv_plain)):
        monkeypatch.setattr(tfa, name, lambda *a, plain=plain: seen.append(a[0].shape[-1])
                            or plain(*a))
    got = grads()
    assert seen == [64, 64]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.float().abs().max()), 1.0)
        assert float((g.float() - w.float()).abs().max()) <= 2 ** -7 * scale


# ---- the forward's tiling and the shared 16-bit head-dim padding


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("L,d", PLAN_SHAPES, ids=lambda v: str(v))
def test_fwd_plan_is_legal(monkeypatch, L, d, dtype, causal):
    """At the kernels' head dim for ``d``, with many heads or one, the
    wgmma body's plan is a tiling the kernel is built for (one or two
    consumer warpgroups with 64-key tiles, or one with 128 at d 64) and a
    ring of 1..4 stages, no more than the sequence has key tiles; the f32
    body takes none. forward_kernel hands it, ``causal`` and the head dim
    to the entry point (the launcher checks the plan's
    shared memory on the card) and counts one launch."""
    dk = tfa.kernel_head_dim(dtype, d)
    for bh in (4096, 1):  # many query tiles (two warpgroups a block where short), few
        p = tfa.fwd_plan(bh, L, dk, dtype)
        if p.body == "f32":
            assert p[1:] == (0, 0, 0)
        else:
            assert (p.warpgroups, p.key_tile) in (((1, 64), (2, 64), (1, 128)) if dk == 64
                                                  else ((1, 64), (2, 64)))
            assert 1 <= p.stages <= min(4, -(-L // p.key_tile))
    calls = _fake_launchers(monkeypatch)
    before = tfa.launch_counts()
    q = torch.zeros(1, L, dk, dtype=dtype)
    tfa.forward_kernel(q, q, q, 0.125, causal)
    assert calls == [("fwd", L, dk, dtype, causal, tuple(p[1:]))]
    assert tfa.launch_counts() == {**before, "forward": before["forward"] + 1}


W = tfa.FwdPlan  # (body, consumer warpgroups, key tile, ring stages)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,L,d,want", [
    (192, 196, 64, W("wgmma", 1, 64, 2)),  # ViT-S train b32 [192, 196, 64]
    (48, 196, 64, W("wgmma", 1, 64, 2)),  # ViT-S serve b8
    (1200, 196, 64, W("wgmma", 2, 64, 4)),  # ViT-S eval b200: over four waves of tiles
    (12, 4096, 64, W("wgmma", 1, 128, 2)),  # ViT-Ti at 1024² [12, 4096, 64]
    (192, 196, 32, W("wgmma", 1, 64, 2)),  # a bf16 d 32 runs at 64
    (96, 196, 128, W("wgmma", 1, 64, 1)),
    (12, 4096, 128, W("wgmma", 2, 64, 2)),
], ids=str)
def test_fwd_plan_pins_the_main_shapes(monkeypatch, bh, L, d, want, causal):
    """The forward's plan at the main path's shapes, at the kernels' head
    dim, and the one forward_kernel passes there, causal or not."""
    dk = tfa.kernel_head_dim(torch.bfloat16, d)
    assert tfa.fwd_plan(bh, L, dk, torch.bfloat16) == want
    calls = _fake_launchers(monkeypatch)
    q = torch.zeros(bh, L, dk, dtype=torch.bfloat16)
    tfa.forward_kernel(q, q, q, 0.125, causal)
    assert calls == [("fwd", L, dk, torch.bfloat16, causal, tuple(want[1:]))]


def test_fwd_plan_is_cached_per_shape():
    tfa.fwd_plan.cache_clear()
    first = tfa.fwd_plan(192, 196, 64, torch.bfloat16)
    assert tfa.fwd_plan(192, 196, 64, torch.bfloat16) is first
    assert tfa.fwd_plan(12, 4096, 64, torch.bfloat16) is not first
    assert tfa.fwd_plan.cache_info().hits == 1


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float16, 128),
                                     (torch.bfloat16, 32), (torch.float32, 32)])
@pytest.mark.parametrize("scale", [0.125, -0.125])
def test_forward_wrapper_passes_the_plan_to_the_launcher(monkeypatch, dtype, d, scale):
    """forward_kernel hands the entry point its plan and a scale ≥ 0 to
    the 16-bit body (a negative scale runs as (−q)·k·(−scale)); f32 takes
    any scale; a 16-bit head dim the wgmma body is not built for raises
    before any launch."""
    scales = []
    calls = _fake_launchers(monkeypatch, scales)
    q = torch.zeros(2, 197, d, dtype=dtype)
    before = tfa.launch_counts()
    if d not in tfa.WGMMA_HEAD_DIMS and dtype != torch.float32:
        with pytest.raises(ValueError, match="head dims"):
            tfa.forward_kernel(q, q, q, scale, True)
        assert calls == [] and tfa.launch_counts() == before
        return
    tfa.forward_kernel(q, q, q, scale, True)
    p = tfa.fwd_plan(2, 197, d, dtype)
    assert calls == [("fwd", 197, d, dtype, True, tuple(p[1:]))]
    assert scales == [abs(scale) if dtype != torch.float32 else scale]
    assert tfa.launch_counts() == {**before, "forward": before["forward"] + 1}


@pytest.mark.parametrize("d", [24, 32])
def test_flash_pads_a_small_16bit_head_dim_once_for_both_passes(monkeypatch, d):
    """On the card the autograd Function zero-pads a bf16 head dim ≤ 32 to
    64 once, in the forward: the forward kernel runs at 64 and the
    backward kernels take the very tensors it saved, not a second padded
    copy. Stood in for on the CPU (the kernel wrappers are the plain
    versions, recording what they are handed); o and the gradients equal
    the unpadded run's."""
    rng = np.random.default_rng(8)
    arrs = [rng.standard_normal((1, 2, 40, d)).astype(np.float32) for _ in range(4)]

    def run():
        q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in arrs[:3])
        o = tfa.flash_attention(q, k, v, causal=True)
        return [o, *torch.autograd.grad((o.float() * torch.tensor(arrs[3])).sum(), (q, k, v))]

    want = run()
    seen = []
    monkeypatch.setattr(tfa.kernel_tier, "use_kernel", lambda t: True)
    for name, plain in (("forward_kernel", tfa.forward_plain), ("dq_kernel", tfa.dq_plain),
                        ("dkdv_kernel", tfa.dkdv_plain)):
        monkeypatch.setattr(tfa, name, lambda *a, plain=plain, name=name: seen.append(
            (name, a[0])) or plain(*a))
    got = run()
    assert [n for n, _ in seen] == ["forward_kernel", "dq_kernel", "dkdv_kernel"]
    assert all(q.shape[-1] == 64 for _, q in seen)
    assert seen[1][1] is seen[0][1] and seen[2][1] is seen[0][1]  # padded once
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.float().abs().max()), 1.0)
        assert float((g.float() - w.float()).abs().max()) <= 2 ** -7 * scale


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,L", [(32, 200), (24, 150), (40, 97)])
def test_padded_plain_forward_equals_unpadded(d, L, dtype, causal):
    """Zero columns added to q, k and v change neither o's first d columns
    nor lse, bit for bit: the padding the kernels run at is exact."""
    q, k, v = (torch.tensor(a).to(dtype) for a in _inputs((3, L, d), 9))
    dp = tfa.kernel_head_dim(torch.bfloat16, d)
    o, lse = tfa.forward_plain(q, k, v, d ** -0.5, causal)
    op, lsep = tfa.forward_plain(*(torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v)),
                                 d ** -0.5, causal)
    assert torch.equal(op[..., :d], o) and torch.equal(lsep, lse)
    assert not op[..., d:].any()
