"""Tests of the port that need the card (marker ``cuda``; they skip without
CUDA). No JAX here, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The conv-epilogue kernel is held against its plain version (tolerances
as in tests/test_torch_conv_epilogue.py) at a shape for every plan of its
bf16 TMA/wgmma body, at ragged edges and in its mma.sync body; a split-K
shape gives the same bits twice and on two streams; and a small ResNet-50 is served
on the card through the engine, every fused site launching the kernel.
EfficientNet-B0's narrow widths (K 16 and 24, N 16, 24 and 40, bf16
silu and id) are held against the plain version, and one bf16 forward of
each image-zoo arch on the card against its f32 CPU forward.
The fused optimizer update is held bit for bit against its plain version
for each body, and a train step launches it exactly once. The three
flash-attention kernels are held against their plain versions at ragged
lengths (ViT-S's 196, 257, 1100 and 4096 among them), causal and not, in
bf16, f16 and f32, at head dims 32, 64 and 128 (each body: TMA + wgmma,
its 16-bit d 32 padded to 64, and f32); every forward and dK/dV plan is
one the launcher takes, and every forward tiling agrees; the forward and
the backward read no other head's rows and give the same bits twice; the
forward takes a negative scale; the gradients through the autograd Function on the
card against the same Function on the CPU; and each launch counter moves
once per call. The decode-attention kernel is
held against its plain version at head dims 32/64/128 in bf16 and f32:
its cluster body at every plan of a set of shapes (lengths −1, 0, 1,
C − 1 and past C, blocks with no live key among them) and at every
tiling the sweep times; the first design at an
unaligned base and an odd head dim; two calls give the same bits and
each call is one launch; a decode step of the generation engine launches
it once per block, and the engine's f32 greedy streams on the card equal
the CPU's. The grouped 3x3
conv kernel is held against its plain version at the RegNets' stage-3
shapes, a ResNeXt shape, a stride-2 shape and a ragged one, in bf16 and
f32; its autograd dx and dW on the card against the CPU's. Its bf16
wgmma body reads no other group's channels (NaN and inf in one group
leave the others equal to the plain version), agrees at every tiling
its launcher takes (ragged M, K and N) and with a one-stage ring; a
base off 16-byte alignment runs the mma.sync body; and its dx at
regnety_160's width agrees with the CPU's autograd.
One graph per step: a serving bucket's replay, a decode tile's replay and
a ResNet-18 train step's replays give the eager calls' bits, and the
launch counts after N replays are the eager calls' counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
from distribuuuu_tpu_torch.ops.cuda import decode_attn as da
from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa
from distribuuuu_tpu_torch.ops.cuda import group_conv as gc
from distribuuuu_tpu_torch.ops.cuda import opt_update as ou
from distribuuuu_tpu_torch.serve import Engine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 0.0625}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,cin,cout,act", [((2, 5, 5), 48, 96, "relu"),
                                               ((3, 7, 5), 37, 53, "silu")])
def test_kernel_matches_plain_on_card(dtype, lead, cin, cout, act):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(*lead, cin, device=dev, generator=g).to(dtype)
    w = (0.1 * torch.randn(cin, cout, device=dev, generator=g)).to(dtype)
    a = 1.0 + 0.3 * torch.randn(cout, device=dev, generator=g)
    c = 0.2 * torch.randn(cout, device=dev, generator=g)
    before = ce.conv1x1_bn_act.launches
    got = ce.conv1x1_bn_act(x, w, a, c, act)
    ref = ce.conv1x1_bn_act_plain(x, w, a, c, act)
    torch.cuda.synchronize()
    assert ce.conv1x1_bn_act.launches == before + 1
    assert got.dtype == dtype and got.shape == (*lead, cout)
    assert float((got.float() - ref.float()).abs().max()) <= TOL[dtype]


def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    x = torch.randn(4, 8, device=dev)
    w, a, c = torch.randn(8, 4, device=dev), torch.ones(4, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ce.conv1x1_bn_act(torch.randn(8, 4, device=dev).t(), w, a, c)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ce.conv1x1_bn_act(x.half(), w.half(), a, c)
    with pytest.raises(ValueError, match="on cpu"):
        ce.conv1x1_bn_act(x, w.cpu(), a, c)


# (name, M, K, N, act, what the plan must give: (bm, bn, split?) or None for
# the mma.sync body). One shape for each plan of the bf16 TMA/wgmma body,
# and the ragged edges: M off the tile, N 232/696/1232, K 32 and 1232.
TMA_CASES = [
    ("full_n_bytes", 25088, 64, 256, "relu", (128, 256, False)),
    ("bn64", 6272, 256, 64, "id", (128, 64, False)),
    ("bn64_split", 2000, 2048, 64, "relu", (128, 64, True)),
    ("regnet_128x128", 1568, 1232, 1232, "id", (128, 128, False)),
    ("bn256_wide", 6272, 448, 1232, "silu", (128, 256, False)),
    ("bm64", 6272, 512, 128, "relu", (64, 128, False)),
    ("split_k", 392, 2048, 512, "relu", (64, 128, True)),
    ("split_ragged", 150, 1232, 232, "relu", (64, 128, True)),
    ("ragged_m_n232", 1000, 224, 232, "relu", (64, 128, False)),
    ("ragged_n696", 3001, 448, 696, "silu", (128, 256, False)),
    ("ragged_k32", 20001, 32, 224, "relu", (128, 256, False)),
    ("ragged_k32_bm64", 3001, 32, 224, "relu", (64, 128, False)),
    ("mma_sync_k36", 300, 36, 64, "relu", None),
    ("mma_sync_n100", 300, 64, 100, "id", None),
]


def _site(dev, m, k, n, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(k, n, device=dev, generator=g) / k ** 0.5).to(torch.bfloat16)
    a = 1.0 + 0.1 * torch.randn(n, device=dev, generator=g)
    c = 0.1 * torch.randn(n, device=dev, generator=g)
    return x, w, a, c


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", TMA_CASES, ids=lambda c: c[0])
def test_tma_kernel_matches_plain_on_card(case, out_dtype):
    """bf16 inputs at every plan and ragged edge, bf16 and f32 outputs; the
    tolerance is the bf16 one (the inputs are bf16, sums run in another
    order), one launch per call."""
    dev = _card()
    _, m, k, n, act, want = case
    bm, bn, splits, stages = ce.plan(m, n, k)
    if want is not None:
        assert (bm, bn, splits > 1) == want
        assert k % 8 == 0 and n % 8 == 0
    else:
        assert k % 8 or n % 8
    x, w, a, c = _site(dev, m, k, n)
    before = ce.conv1x1_bn_act.launches
    got = ce.conv1x1_bn_act(x, w, a, c, act, out_dtype=out_dtype)
    ref = ce.conv1x1_bn_act_plain(x, w, a, c, act, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ce.conv1x1_bn_act.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert float((got.float() - ref.float()).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("act", ["silu", "id"])
@pytest.mark.parametrize("k,n", [(16, 96), (24, 144), (96, 24), (144, 24), (240, 40),
                                 (32, 16), (16, 16)])
def test_kernel_at_efficientnet_widths_on_card(k, n, act):
    """EfficientNet-B0's narrow 1x1s in bf16: K of 16 and 24 (one
    partial ring stage, the rest zero-filled), N of 16, 24 and 40 (under
    the narrowest 64-column tile: stores clipped at N), silu and id."""
    dev = _card()
    m = 8 * 56 * 56 + 7  # ragged rows
    x, w, a, c = _site(dev, m, k, n)
    before = ce.conv1x1_bn_act.launches
    got = ce.conv1x1_bn_act(x, w, a, c, act)
    ref = ce.conv1x1_bn_act_plain(x, w, a, c, act)
    torch.cuda.synchronize()
    assert ce.conv1x1_bn_act.launches == before + 1
    assert got.shape == (m, n)
    assert float((got.float() - ref.float()).abs().max()) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("arch", ["efficientnet_b0", "botnet50", "densenet121", "densenet161",
                                  "densenet169", "densenet201"])
def test_zoo_bf16_forward_on_card_matches_cpu_f32(arch):
    """One bf16 eval forward of each image-zoo arch at full width on the
    card (64², botnet50's grid 4²) against the same weights in f32 on the
    CPU: within 0.05 of the logit scale; every conv-epilogue site
    launches the kernel. Every BN is first moved off its init stats (as
    chip_smoke.seeded_bn does), which keep no activation normalized in
    eval: EfficientNet's logits would vanish, DenseNet's grow, and
    BoTNet's bf16 attention logits would round across their argmax."""
    dev = _card()
    kw = {"fmap_size": (4, 4)} if arch == "botnet50" else {}
    model = build_model(arch, num_classes=1000, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "running_var"):
                c = m.weight.shape[0]
                m.weight.copy_(0.4 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    ref = build_model(arch, num_classes=1000, dtype=torch.float32, **kw)
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    sites = sum(u.fused for u in model.conv_units())
    before = ce.conv1x1_bn_act.launches
    with torch.inference_mode():
        got = model.to(dev).eval()(x.to(dev)).float().cpu().numpy()
        cpu = ref.eval()(x).numpy()
    assert ce.conv1x1_bn_act.launches == before + sites
    assert np.isfinite(got).all()
    assert np.abs(got - cpu).max() / np.abs(cpu).max() <= 0.05


def test_split_k_is_bitwise_repeatable_across_launches_and_streams():
    """The last split sums the partials in split order: two launches, and
    the same launch on two streams at once (each with its own workspace),
    give the same bits."""
    dev = _card()
    m, k, n = 392, 2048, 512
    assert ce.plan(m, n, k)[2] > 1
    x, w, a, c = _site(dev, m, k, n, seed=9)
    first = ce.conv1x1_bn_act(x, w, a, c, "relu")
    second = ce.conv1x1_bn_act(x, w, a, c, "relu")
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    s1.wait_stream(torch.cuda.current_stream(dev))
    s2.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s1):
        on1 = [ce.conv1x1_bn_act(x, w, a, c, "relu") for _ in range(4)]
    with torch.cuda.stream(s2):
        on2 = [ce.conv1x1_bn_act(x, w, a, c, "relu") for _ in range(4)]
    torch.cuda.synchronize()
    for out in (second, *on1, *on2):
        assert torch.equal(out, first)


def test_engine_on_card_launches_kernel_at_every_fused_site():
    dev = _card()
    model = build_model("resnet50", num_classes=10, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    ref = build_model("resnet50", num_classes=10, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ce.conv1x1_bn_act.launches = 0
    eng = Engine(model, 32, device=dev, max_batch=4, bucket_sizes=[2, 4],
                 max_wait_ms=50.0, max_queue=16).start()
    images = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3), np.uint8)
    got = np.stack([f.result(timeout=120) for f in [eng.submit(i) for i in images]])
    eng.drain()
    assert ce.conv1x1_bn_act.launches == 33 * (eng.stats()["batches"] + eng.n_compiles)
    with torch.inference_mode():
        cpu = ref.eval()(normalize_on_device(torch.from_numpy(images))).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - cpu).max() / np.abs(cpu).max() <= 0.05  # bf16 card vs f32 CPU


OPT_BODIES = {
    "sgd_nesterov_f32": (dict(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), torch.float32),
    "sgd_f32": (dict(kind="sgd", wd=5e-5, mom=0.9), torch.float32),
    "sgd_nesterov_bf16": (dict(kind="sgd", wd=5e-5, mom=0.9, nesterov=True), torch.bfloat16),
    "sgd_no_momentum": (dict(kind="sgd", wd=5e-5), None),
    "adamw": (dict(kind="adamw", wd=5e-5), torch.float32),
}


@pytest.mark.parametrize("body", list(OPT_BODIES))
def test_opt_update_kernel_matches_plain_on_card(body):
    """Leaves of ragged sizes (one spans several chunks), three steps."""
    dev = _card()
    hkw, mdt = OPT_BODIES[body]
    h = ou.Hyper(**hkw)
    g = torch.Generator(device=dev).manual_seed(7)
    shapes = [(37, 13), (5,), (70_001,), (3, 3, 64, 64)]
    p = [torch.randn(s, device=dev, generator=g) for s in shapes]
    m = None if mdt is None else [torch.zeros(s, device=dev, dtype=mdt) for s in shapes]
    v = [torch.zeros(s, device=dev) for s in shapes] if h.kind == "adamw" else None
    kp, km, kv = ([t.clone() for t in x] if x else None for x in (p, m, v))
    before = ou.update.launches
    for step in range(1, 4):
        grads = [0.1 * torch.randn(s, device=dev, generator=g) for s in shapes]
        scal = ou.staged_scalars(h, 0.1 / step, step, kp, km)
        ou.update(kp, grads, km, kv, h, scal)
        ou.update_plain(p, grads, m, v, h, scal)
    torch.cuda.synchronize()
    assert ou.update.launches == before + 3
    for got, want in zip([*kp, *(km or []), *(kv or [])], [*p, *(m or []), *(v or [])]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_opt_update_refuses_what_it_does_not_take():
    dev = _card()
    h = ou.Hyper(kind="sgd", mom=0.9)
    p, gr = torch.zeros(4, device=dev), torch.zeros(4, device=dev)
    s = ou.staged_scalars(h, 0.1, 1, [p])
    with pytest.raises(TypeError, match="f32 params"):
        ou.update([p.double()], [gr.double()], [p.double()], None, h, s)
    with pytest.raises(ValueError, match="on cpu"):
        ou.update([p], [gr.cpu()], [p.clone()], None, h, s)
    with pytest.raises(TypeError, match="moment"):
        ou.update([p], [gr], [p.half()], None, h, s)
    with pytest.raises(ValueError, match="scalar table"):
        ou.update([p], [gr], [p.clone()], None, h, s.cpu())


# of the reference's scale; f16 rounds p and dS as bf16 does, with more bits
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6, torch.float16: 2 ** -6}


def _flash_inputs(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(4)]


def _close(got, want, tol):
    scale = max(float(want.float().abs().max()), 1.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


FLASH_CARD_SHAPES = [  # (BH, L, d): the backward's query tile, ring and ragged last tile
    (6, 150, 64),  # dK/dV query tile 32, a four-stage ring, ragged
    (3, 70, 32),  # the forward at d 32; the 16-bit backward padded to 64; two key tiles
    (2, 200, 128),  # d 128: two boxes a row, query tile 32
    (4, 196, 64),  # ViT-S's length: every query tile in flight at once
    (2, 257, 128),  # one query (key) past four tiles: a last tile of one row
    (2, 1100, 128),  # past SHORT at d 128: query tile 32, a two-stage ring, ragged
    (2, 4096, 64),  # ViT-Ti at 1024²: query tile 64, a two-stage ring
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,L,d", FLASH_CARD_SHAPES)
def test_flash_kernels_match_plain_on_card(dtype, causal, bh, L, d):
    """Each of the three kernels against its plain version on the same
    inputs, at ragged lengths (masked key and query tails), for both
    bodies: wgmma (bf16/f16 at d 64 and 128, and at 32 padded to 64 as the
    autograd Function pads it, forward and backward) and f32."""
    dev = _card()
    q, k, v, do = _flash_inputs(dev, (bh, L, d), dtype)
    scale = d ** -0.5
    db = fa.kernel_head_dim(dtype, d)
    q, k, v, do = (torch.nn.functional.pad(t, (0, db - d)) for t in (q, k, v, do))
    before = fa.launch_counts()
    o, lse = fa.forward_kernel(q, k, v, scale, causal)
    o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.dq_kernel(q, k, v, do, lse_ref, delta, scale, causal)
    dk, dv = fa.dkdv_kernel(q, k, v, do, lse_ref, delta, scale, causal)
    dq_ref = fa.dq_plain(q, k, v, do, lse_ref, delta, scale, causal)
    dk_ref, dv_ref = fa.dkdv_plain(q, k, v, do, lse_ref, delta, scale, causal)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {n: c + 1 for n, c in before.items()}
    tol = FLASH_TOL[dtype]
    _close(o, o_ref, tol)
    _close(lse, lse_ref, 1e-5)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, want, tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [196, 4096, 150, 197, 4097, 70, 1100])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_forward_launches_every_plan(causal, L, d):
    """The forward's plan at every length and head dim the CPU tests pin
    is one the launcher takes (its shared-memory check is the only copy of
    the kernel's layout), and the forward agrees with its plain version
    there, in bf16 at the kernels' head dim."""
    dev = _card()
    dk = fa.kernel_head_dim(torch.bfloat16, d)
    q, k, v, _ = _flash_inputs(dev, (1, L, dk), torch.bfloat16, seed=L)
    scale = d ** -0.5
    o, lse = fa.forward_kernel(q, k, v, scale, causal)
    o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[torch.bfloat16])
    _close(lse, lse_ref, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_takes_every_tiling(causal, d):
    """Every tiling the forward's launcher is built for (one or two
    consumer warpgroups with 64-key tiles, or one with 128 at d 64; ring
    stages 1 to 4)
    agrees with the plain forward at a ragged length, not only the ones
    fwd_plan picks."""
    import flash_fwd_sweep as sweep

    dev = _card()
    L, scale = 333, d ** -0.5
    q, k, v, _ = _flash_inputs(dev, (3, L, d), torch.bfloat16, seed=9)
    o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
    plans = list(sweep.tilings(L, d))
    assert len(plans) == (11 if d == 64 else 8)
    for plan in plans:
        o, lse = sweep.launch(torch, fa, q, k, v, scale, causal, plan)
        torch.cuda.synchronize()
        _close(o, o_ref, FLASH_TOL[torch.bfloat16])
        _close(lse, lse_ref, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_at_many_heads(causal, d):
    """Far more query tiles than the card holds blocks (several waves):
    the plan takes two consumer warpgroups a block sharing each K/V tile,
    and every head is right."""
    dev = _card()
    L, scale = 197, d ** -0.5
    q, k, v, _ = _flash_inputs(dev, (1500, L, d), torch.bfloat16, seed=4)
    assert fa.fwd_plan(1500, L, d, torch.bfloat16).warpgroups == 2
    o, lse = fa.forward_kernel(q, k, v, scale, causal)
    o_ref, lse_ref = fa.forward_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[torch.bfloat16])
    _close(lse, lse_ref, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_reads_no_other_head(causal, d):
    """Head 1 holds NaN everywhere; heads 0 and 2 (L = 197: a ragged last
    tile, whose rows past L must read zeros, not the next head's) give the
    same o and lse bits as each run alone. A masked key times a NaN read
    from head 1 is NaN, so a read across the head boundary cannot hide
    behind the mask."""
    dev = _card()
    L, scale = 197, d ** -0.5
    q, k, v, _ = _flash_inputs(dev, (3, L, d), torch.bfloat16, seed=5)
    for t in (q, k, v):
        t[1] = float("nan")
    o, lse = fa.forward_kernel(q, k, v, scale, causal)
    for h in (0, 2):
        o1, lse1 = fa.forward_kernel(*(t[h:h + 1].clone() for t in (q, k, v)), scale, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(o1.float()).all() and torch.isfinite(lse1).all()
        assert torch.equal(o[h], o1[0]) and torch.equal(lse[h], lse1[0])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,L,d", [(24, 196, 64), (3, 1100, 64), (2, 300, 128)])
def test_flash_forward_is_bitwise_repeatable(bh, L, d, causal):
    """Each block owns its output rows and sums its key tiles in one
    order, so two launches give the same bits."""
    dev = _card()
    q, k, v, _ = _flash_inputs(dev, (bh, L, d), torch.bfloat16, seed=6)
    first = fa.forward_kernel(q, k, v, d ** -0.5, causal)
    second = fa.forward_kernel(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_forward_takes_a_negative_scale(dtype):
    """The 16-bit body takes scale >= 0; the wrapper runs a negative scale
    as (-q).k.(-scale), which is exact, and the launcher refuses one
    handed to it directly."""
    dev = _card()
    q, k, v, _ = _flash_inputs(dev, (4, 150, 64), dtype, seed=8)
    o, lse = fa.forward_kernel(q, k, v, -0.2, True)
    o_ref, lse_ref = fa.forward_plain(q, k, v, -0.2, True)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, 1e-5)
    import flash_fwd_sweep as sweep

    with pytest.raises(RuntimeError, match="flash_fwd_launch failed"):
        sweep.launch(torch, fa, q, k, v, -0.2, True, tuple(fa.fwd_plan(4, 150, 64, dtype)[1:]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [196, 4096, 150, 197, 4097, 70, 1100, 256])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_backward_launches_every_plan(causal, L, d):
    """The dK/dV plan of every length and head dim the CPU tests pin is
    one the launcher takes (its shared-memory check is the only copy of
    the kernels' layout), and both backward kernels agree with their plain
    versions there, in bf16 at the backward's head dim."""
    dev = _card()
    db = fa.kernel_head_dim(torch.bfloat16, d)
    q, k, v, do = _flash_inputs(dev, (1, L, db), torch.bfloat16, seed=L)
    scale = d ** -0.5
    o, lse = fa.forward_plain(q, k, v, scale, causal)
    args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), scale, causal)
    got = [fa.dq_kernel(*args), *fa.dkdv_kernel(*args)]
    want = [fa.dq_plain(*args), *fa.dkdv_plain(*args)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w, FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_reads_no_other_head(causal, d):
    """Head 1 holds NaN everywhere (inputs, lse, delta); heads 0 and 2
    (L = 197: a ragged last tile, whose rows past L must read zeros, not
    the next head's) give the same dQ, dK and dV bits as each run alone.
    A masked pair times a NaN read from head 1 is NaN, so a read across
    the head boundary cannot hide behind the mask."""
    dev = _card()
    L, scale = 197, d ** -0.5
    q, k, v, do = _flash_inputs(dev, (3, L, d), torch.bfloat16, seed=5)
    for t in (q, k, v, do):
        t[1] = float("nan")
    _, lse = fa.forward_plain(q, k, v, scale, causal)
    delta = (do.float() * fa.forward_plain(q, k, v, scale, causal)[0].float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq, (dk, dv) = fa.dq_kernel(*args, scale, causal), fa.dkdv_kernel(*args, scale, causal)
    for h in (0, 2):
        one = [t[h:h + 1].clone() for t in args]
        dq1, (dk1, dv1) = fa.dq_kernel(*one, scale, causal), fa.dkdv_kernel(*one, scale, causal)
        torch.cuda.synchronize()
        for got, alone in ((dq, dq1), (dk, dk1), (dv, dv1)):
            assert torch.isfinite(alone.float()).all()
            assert torch.equal(got[h], alone[0])


@pytest.mark.parametrize("bh,L,d", [(24, 196, 64), (3, 1100, 64), (2, 300, 128)])
def test_flash_backward_is_bitwise_repeatable(bh, L, d):
    """No atomics: each kernel owns its output rows, so two launches give
    the same bits."""
    dev = _card()
    q, k, v, do = _flash_inputs(dev, (bh, L, d), torch.bfloat16, seed=6)
    scale = d ** -0.5
    o, lse = fa.forward_kernel(q, k, v, scale, False)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, False)
    first = [fa.dq_kernel(*args), *fa.dkdv_kernel(*args)]
    second = [fa.dq_kernel(*args), *fa.dkdv_kernel(*args)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _cpu_math_state() -> dict:
    """The process state that could change the CPU's f32 arithmetic."""
    state = {"threads": torch.get_num_threads(),
             "interop_threads": torch.get_num_interop_threads(),
             "float32_matmul_precision": torch.get_float32_matmul_precision(),
             "mkldnn_enabled": torch.backends.mkldnn.enabled}
    for name in ("fp32_precision", "matmul.fp32_precision", "conv.fp32_precision"):
        node = torch.backends.mkldnn
        for part in name.split("."):
            node = getattr(node, part, None)
        state[f"mkldnn.{name}"] = node
    return state


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_on_card_match_the_cpu(causal):
    """Gradients through the autograd Function on the card (the kernels)
    against the same Function on the CPU (the plain versions), f32, with a
    head dim the kernels pad (40 → 64) and an lse cotangent. On a miss it
    reports the CPU's arithmetic state and whether a second CPU call gives
    the first call's bits.

    The CPU side runs once before it is measured: in a fresh process the
    first ``torch.exp`` after the first batched matmul sometimes computes
    one OpenMP thread's share of its elements 1.5e-4 off (6 of 300 fresh
    processes at 8 threads: ``python -m
    distribuuuu_tpu_torch.ops.cuda.flash_drift_probe --first-calls 300``),
    and this test was the first CPU caller of the Function in the card
    test file."""
    dev = _card()
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 3, 97, 40)).astype(np.float32) for _ in range(5)]
    g_lse = rng.standard_normal((2, 3, 97)).astype(np.float32)

    def run(device):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True) for a in arrs[:3])
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        loss = (o * torch.tensor(arrs[3], device=device)).sum() + \
            (lse * torch.tensor(g_lse, device=device)).sum()
        return [t.detach().cpu() for t in (o, lse, *torch.autograd.grad(loss, (q, k, v)))]

    def errors(got, want):
        return [float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
                for a, b in zip(got, want)]

    run(torch.device("cpu"))  # the runtime's first-call exp, not the Function's
    card, cpu = run(dev), run(torch.device("cpu"))
    errs = errors(card, cpu)
    if max(errs) > 1e-5:
        again = run(torch.device("cpu"))
        pytest.fail(f"card vs CPU scaled errors {errs} over 1e-5; CPU state "
                    f"{_cpu_math_state()}; a second CPU call is bitwise the first: "
                    f"{all(torch.equal(a, b) for a, b in zip(again, cpu))}, its errors "
                    f"{errors(card, again)}")
    for got, want in zip(card, cpu):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_on_card_match_f64(causal):
    """The inputs of test_flash_gradients_on_card_match_the_cpu through the
    autograd Function on the card (the f32 kernels) against a dense f64
    reference, within the same 1e-5, twice with the same bits. That test
    failed now and then on the card's host when its CPU call was the
    process's first (a first-call defect of the CPU runtime's ``exp``; it
    now warms the CPU path): each time the CPU's f32 Function, not the
    card, had drifted (1.3e-5 to 3.3e-5 from f64 on every output), while
    the card stayed within 1e-6 of f64. This one holds the kernels
    without the CPU's f32 path."""
    dev = _card()
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 3, 97, 40)) for _ in range(5)]
    g_lse = rng.standard_normal((2, 3, 97))

    def card():
        q, k, v = (torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
                   for a in arrs[:3])
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        loss = (o * torch.tensor(arrs[3], dtype=torch.float32, device=dev)).sum() + \
            (lse * torch.tensor(g_lse, dtype=torch.float32, device=dev)).sum()
        return [t.detach().cpu() for t in (o, lse, *torch.autograd.grad(loss, (q, k, v)))]

    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrs[:3])
    s = q @ k.transpose(-1, -2) / 40 ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(97, 97, dtype=torch.bool).triu(1), float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.softmax(s, -1) @ v
    loss = (o * torch.tensor(arrs[3])).sum() + (lse * torch.tensor(g_lse)).sum()
    want = [t.float() for t in (o.detach(), lse.detach(), *torch.autograd.grad(loss, (q, k, v)))]
    first, second = card(), card()
    for got, again, w in zip(first, second, want):
        assert torch.equal(got, again)
        _close(got, w, 1e-5)


def test_flash_attention_launches_each_kernel_once_per_call():
    dev = _card()
    q, k, v, _ = (t.requires_grad_() for t in _flash_inputs(dev, (2, 6, 196, 64),
                                                           torch.bfloat16))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    assert fa.launch_counts() == {"forward": 1, "dq": 0, "dkdv": 0}
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"forward": 1, "dq": 1, "dkdv": 1}
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        fa.flash_attention(q.double(), k.double(), v.double())


def test_one_opt_update_launch_per_train_step():
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    dev = _card()
    model = build_model("resnet18", num_classes=10, dtype=torch.bfloat16, bn_group=4,
                        generator=torch.Generator().manual_seed(0)).to(dev).train()
    opt = construct_optimizer(model)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), np.uint8)).to(dev),
             "label": torch.zeros(8, dtype=torch.int32, device=dev)}
    before = ou.update.launches
    losses = [float(trainer.train_step(model, opt, batch, 5)["loss"]) for _ in range(3)]
    assert ou.update.launches == before + 3 and opt.count == 3
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,c,d", [(3, 4, 256, 32), (2, 6, 256, 64), (2, 2, 384, 128),
                                     (3, 2, 96, 32)])
def test_decode_attention_kernel_matches_plain_on_card(dtype, b, h, c, d):
    """The kernel against its plain version at lengths 0, mid and C − 1
    (C = 96 lies inside one 128-key block)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(b, h, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, h, c, d, device=dev, generator=g).to(dtype) for _ in range(2))
    lens = torch.tensor([0, c // 2, c - 1][:b], dtype=torch.int32, device=dev)
    before = da.launches
    got = da.decode_attention(q, k, v, lens, scale=d ** -0.5)
    want = da.decode_attention_plain(q, k, v, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    _close(got, want, FLASH_TOL[dtype])
    with pytest.raises(TypeError, match="f32 or bf16"):
        da.decode_attention(q.half(), k.half(), v.half(), lens, scale=1.0)


DECODE_CARD_SHAPES = [  # (B, H, C): plans of 1, 2, 3, 4, 6 and 8 splits, one or two stages
    (5, 4, 256),  # GPT-nano's tile with one more row
    (5, 8, 1024),  # a longer cache: eight blocks a row
    (5, 2, 96),  # a tile inside one TPU block
    (5, 1, 40),  # fewer keys than two key groups: one block a row
    (5, 3, 2000),  # long rows: several stages a block
    (5, 16, 4096),  # the bandwidth probe's rows
]


def _decode_inputs(dev, b, h, c, d, dtype, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, h, c, d, device=dev, generator=g).to(dtype) for _ in range(2))
    lens = torch.tensor([-1, 0, 1, c - 1, c + 5][:b], dtype=torch.int32, device=dev)
    return q, k, v, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b,h,c", DECODE_CARD_SHAPES, ids=str)
def test_decode_split_body_matches_plain_at_every_plan(dtype, d, b, h, c):
    """The cluster body at the plan of each shape: a negative length gives
    0, a length past C reads all C keys, one launch a call."""
    dev = _card()
    q, k, v, lens = _decode_inputs(dev, b, h, c, d, dtype)
    assert da.kernel_body(q, k, v) == "split"
    before = da.launches
    got = da.decode_attention(q, k, v, lens, scale=d ** -0.5, blk_k=c)
    want = da.decode_attention_plain(q, k, v, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    assert float(got[0].abs().max()) == 0.0  # length -1
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_split_body_takes_every_tiling(d, dtype):
    """Every tiling the sweep times (splits 1–8, stages of 4–32 KB, 1–4
    stages) at a ragged cache of 300 keys."""
    from distribuuuu_tpu_torch.ops.cuda import decode_sweep

    dev = _card()
    b, h, c = 5, 2, 300
    q, k, v, lens = _decode_inputs(dev, b, h, c, d, dtype, seed=5)
    want = da.decode_attention_plain(q, k, v, lens, d ** -0.5)
    for t in decode_sweep.tilings(b, h, c, d, dtype):
        got = da.decode_attention_kernel(q, k, v, lens, d ** -0.5, tiling=t)
        torch.cuda.synchronize()
        _close(got, want, FLASH_TOL[dtype])


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["q", "k", "v", "odd_d"])
def test_decode_simple_body_takes_what_the_bulk_copy_cannot(dtype, case):
    """A base off 16-byte alignment, or a head dim that is not a whole
    number of 16-byte pieces, runs the first design, which agrees with the
    plain version."""
    dev = _card()
    d = 33 if case == "odd_d" else 64
    q, k, v, lens = _decode_inputs(dev, 5, 4, 256, d, dtype, seed=7)
    if case == "q":
        q = _offset(q)
    elif case == "k":
        k = _offset(k)
    elif case == "v":
        v = _offset(v)
    assert da.kernel_body(q, k, v) == "simple"
    before = da.launches
    got = da.decode_attention(q, k, v, lens, scale=d ** -0.5)
    want = da.decode_attention_plain(q, k, v, lens, d ** -0.5)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("b,h,c,d", [(4, 4, 256, 32), (32, 4, 256, 32), (8, 16, 4096, 128)])
def test_decode_attention_is_bitwise_repeatable(b, h, c, d):
    """The cluster merges its blocks in rank order: two calls, one launch
    each, give the same bits."""
    dev = _card()
    q, k, v, _ = _decode_inputs(dev, b, h, c, d, torch.bfloat16, seed=9)
    lens = torch.randint(0, c, (b,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    before = da.launches
    first = da.decode_attention(q, k, v, lens, scale=d ** -0.5, blk_k=c)
    second = da.decode_attention(q, k, v, lens, scale=d ** -0.5, blk_k=c)
    torch.cuda.synchronize()
    assert da.launches == before + 2
    assert torch.equal(first, second)


def _tiny_gpt(dtype):
    return build_model("gpt_nano", num_classes=320, dtype=dtype, seq_len=32, dim=64,
                       depth=3, num_heads=2, generator=torch.Generator().manual_seed(0))


def test_one_decode_attention_launch_per_block_per_decode_step():
    from distribuuuu_tpu_torch.lm.generate import GenerateEngine

    dev = _card()
    eng = GenerateEngine(_tiny_gpt(torch.bfloat16), device=dev, prompt_len=8,
                         max_new_tokens=4, batch_tiles=[1, 2], cache_tiles=[32], eos_id=-1)
    warm = da.launches
    eng.start()
    da.reset_launch_counts()
    try:
        out = eng.submit([1, 2, 3]).result(timeout=120)
    finally:
        eng.drain()
    assert warm >= 3 * 2  # every decode tile warmed once
    assert len(out) == 4 and eng.stats()["decode_steps"] == 3
    assert da.launches == 3 * 3  # depth 3, three decode steps after the prefill


def test_f32_greedy_streams_on_card_match_the_cpu():
    from distribuuuu_tpu_torch.lm.generate import GenerateEngine

    dev = _card()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (3, 8, 5)]
    streams = []
    for device in (dev, torch.device("cpu")):
        eng = GenerateEngine(_tiny_gpt(torch.float32), device=device, prompt_len=8,
                             max_new_tokens=12, batch_tiles=[1, 2, 4], cache_tiles=[32],
                             eos_id=-1).start()
        try:
            streams.append([s.result(timeout=120) for s in [eng.submit(p) for p in prompts]])
        finally:
            eng.drain()
    assert streams[0] == streams[1]


# of max(1, max |ref|): bf16 is one rounding of the output apart (fp32 sums
# in another order); f32 sums in another order
GROUP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
GROUP_SHAPES = [  # (B, H, W, C, G, stride)
    (8, 14, 14, 1232, 11, 1),  # regnety_160 stage 3
    (8, 14, 14, 896, 7, 1),  # regnetx_160 stage 3
    (8, 14, 14, 1392, 6, 1),  # regnety_320 stage 3 (cg = 232: a ragged K chunk)
    (8, 14, 14, 512, 32, 1),  # resnext50_32x4d stage 3 (cg = 16)
    (4, 28, 28, 448, 4, 2),  # a stride-2 site
    (3, 7, 5, 33, 3, 1),  # ragged everything (cg = 11)
]


def _group_inputs(dev, shape, dtype, seed=0):
    b, h, w, c, g, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    wt = torch.randn(c, c // g, 3, 3, device=dev, generator=gen) / (9 * c // g) ** 0.5
    return x, wt.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GROUP_SHAPES, ids=str)
def test_group_conv_kernel_matches_plain_on_card(dtype, shape):
    dev = _card()
    *_, g, s = shape
    x, w = _group_inputs(dev, shape, dtype)
    before = gc.group_conv3x3.launches
    got = gc.group_conv3x3(x, w, s, g)
    want = gc.group_conv3x3_plain(x, w, s, g)
    torch.cuda.synchronize()
    assert gc.group_conv3x3.launches == before + 1
    _close(got, want, GROUP_TOL[dtype])


def test_group_conv_gradients_on_card_match_the_cpu():
    """dx (the kernel on the flipped weight) and dW through the autograd
    Function on the card against the same Function on the CPU, f32."""
    dev = _card()
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 14, 14, 96)).astype(np.float32)
    w = (0.1 * rng.standard_normal((96, 24, 3, 3))).astype(np.float32)
    dy = rng.standard_normal((4, 14, 14, 96)).astype(np.float32)
    grads = []
    for device in (dev, torch.device("cpu")):
        tx = torch.tensor(x, device=device, requires_grad=True)
        tw = torch.tensor(w, device=device).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        before = (gc.group_conv3x3.launches, gc.group_conv3x3.launches_dx)
        out = gc.group_conv3x3(tx, tw, 1, 4)
        grads.append([t.detach().cpu() for t in (
            out, *torch.autograd.grad(out, (tx, tw), torch.tensor(dy, device=device)))])
        moved = (gc.group_conv3x3.launches - before[0], gc.group_conv3x3.launches_dx - before[1])
        assert moved == ((1, 1) if device.type == "cuda" else (0, 0))
    for got, want in zip(*grads):
        _close(got, want, 1e-5)


def test_group_conv_refuses_what_it_does_not_take():
    dev = _card()
    x, w = _group_inputs(dev, (2, 6, 6, 16, 2, 1), torch.float32)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        gc.group_conv3x3(x.transpose(1, 2), w, 1, 2)
    with pytest.raises(ValueError, match="channels-last"):
        gc.group_conv3x3(x, w.contiguous(), 1, 2)
    with pytest.raises(TypeError, match="bf16 or f32"):
        gc.group_conv3x3(x.half(), w.half(), 1, 2)
    with pytest.raises(ValueError, match="on cpu"):
        gc.group_conv3x3(x, w.cpu(), 1, 2)


@pytest.mark.parametrize("shape", [(2, 14, 14, 1232, 11, 1), (2, 14, 14, 1392, 6, 1),
                                   (2, 28, 28, 1232, 11, 2)], ids=str)
def test_group_conv_reads_no_other_group(shape):
    """NaN and inf in one group's input channels: every other group's
    output stays finite and equal to the plain version. The wgmma body
    gathers only its group's channels (cg 112 and 232 are not multiples
    of a 64-channel box, so a box-wide load would reach the neighbours)."""
    dev = _card()
    *_, g, s = shape
    x, w = _group_inputs(dev, shape, torch.bfloat16, seed=3)
    cg, bad = shape[3] // g, g // 2
    x[..., bad * cg:(bad + 1) * cg:2] = float("nan")
    x[..., bad * cg + 1:(bad + 1) * cg:2] = float("inf")
    assert gc.kernel_body(x, w, g) == "wgmma"
    got, want = gc.group_conv3x3(x, w, s, g), gc.group_conv3x3_plain(x, w, s, g)
    torch.cuda.synchronize()
    fg = w.shape[0] // g
    keep = torch.ones(g * fg, dtype=torch.bool, device=dev)
    keep[bad * fg:(bad + 1) * fg] = False
    assert bool(torch.isfinite(got[..., keep]).all())
    _close(got[..., keep], want[..., keep], GROUP_TOL[torch.bfloat16])


@pytest.mark.parametrize("shape", [
    (3, 14, 14, 1392, 6, 1),  # cg 232: M 588 and K 2088 ragged in tiles of 64 and 128
    (3, 7, 5, 448, 4, 1),  # cg 112: M 105, K 1008 ragged
    (2, 9, 9, 192, 4, 1),  # cg 48: fg in N tiles of 64, the last one past the group
], ids=str)
def test_group_conv_takes_every_tiling(shape):
    """Every tiling the wgmma body's launcher takes (one or two consumer
    warpgroups, 1 to the most stages that fit) agrees with the plain
    version at ragged edges, not only the one ``plan`` picks."""
    import group_conv_sweep as sweep

    dev = _card()
    *_, g, s = shape
    x, w = _group_inputs(dev, shape, torch.bfloat16, seed=5)
    want = gc.group_conv3x3_plain(x, w, s, g)
    cg = shape[3] // g
    plans = list(sweep.tilings(cg, cg))
    assert {p.warpgroups for p in plans} == {1, 2} and min(p.stages for p in plans) == 1
    for plan in plans:
        got = gc._launch(x, w, s, g, plan)
        torch.cuda.synchronize()
        _close(got, want, GROUP_TOL[torch.bfloat16])


@pytest.mark.parametrize("warpgroups", [1, 2])
def test_group_conv_one_stage_ring(warpgroups):
    """A ring of one stage at regnety_160's stage-3 width: the producer
    waits for the consumers to free the only stage before each load (a
    fault there deadlocks the ring, which traps after 4 s)."""
    dev = _card()
    shape = (4, 14, 14, 1232, 11, 1)
    x, w = _group_inputs(dev, shape, torch.bfloat16, seed=6)
    got = gc._launch(x, w, 1, 11, gc.GroupPlan(warpgroups, 1))
    want = gc.group_conv3x3_plain(x, w, 1, 11)
    torch.cuda.synchronize()
    _close(got, want, GROUP_TOL[torch.bfloat16])


def _unaligned(t: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """A copy of ``t`` at a storage offset of one element (2 bytes past
    16-byte alignment), contiguous (NHWC) or in channels-last order."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    if channels_last:
        n, c, h, w = t.shape
        out = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    else:
        out = buf[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("which", ["x", "weight"])
def test_group_conv_unaligned_base_runs_the_mma_sync_body(which):
    """A bf16 base that is not 16-byte aligned cannot feed cp.async or TMA:
    the launcher routes it to the mma.sync body, which agrees with the
    plain version."""
    dev = _card()
    shape = (2, 14, 14, 1232, 11, 1)
    x, w = _group_inputs(dev, shape, torch.bfloat16, seed=8)
    if which == "x":
        x = _unaligned(x, channels_last=False)
    else:
        w = _unaligned(w, channels_last=True)
    assert gc.kernel_body(x, w, 11) == "mma_sync"
    before = gc.group_conv3x3.launches
    got = gc.group_conv3x3(x, w, 1, 11)
    want = gc.group_conv3x3_plain(x, w, 1, 11)
    torch.cuda.synchronize()
    assert gc.group_conv3x3.launches == before + 1
    _close(got, want, GROUP_TOL[torch.bfloat16])


def test_group_conv_dx_at_regnety_160_width_matches_cpu_autograd():
    """dx of a bf16 stride-1 site at regnety_160's stage-3 width (the
    wgmma body on the flipped weight) against the same Function on the
    CPU in f32 from the same bf16 values: one bf16 rounding apart."""
    dev = _card()
    rng = np.random.default_rng(7)
    b, hw, c, g = 2, 14, 1232, 11
    x = torch.tensor(rng.standard_normal((b, hw, hw, c)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((c, c // g, 3, 3)) / (9 * c // g) ** 0.5,
                     dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.tensor(rng.standard_normal((b, hw, hw, c)), dtype=torch.bfloat16)
    tx, tw = x.to(dev).requires_grad_(), w.to(dev)
    assert gc.kernel_body(dy.to(dev), gc.flipped_weight(tw, g), g) == "wgmma"
    before = gc.group_conv3x3.launches_dx
    (dx,) = torch.autograd.grad(gc.group_conv3x3(tx, tw, 1, g), (tx,), dy.to(dev))
    torch.cuda.synchronize()
    assert gc.group_conv3x3.launches_dx == before + 1
    cx = x.float().requires_grad_()
    (want,) = torch.autograd.grad(gc.group_conv3x3(cx, w.float(), 1, g), (cx,), dy.float())
    _close(dx.float().cpu(), want, GROUP_TOL[torch.bfloat16])


# ------------------------------------------------------- one graph per step


def _launches():
    from distribuuuu_tpu_torch.ops import cuda as kernel_tier

    return kernel_tier.launch_counts()


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a if b[k] != a[k]}


def test_serving_bucket_replay_equals_eager():
    """ResNet-50 (bf16) at bucket 4: the graph's logits are the eager
    engine's, bit for bit, and 3 replays count the eager calls' launches."""
    dev = _card()
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(3)]
    out = {}
    for name in ("graph", "eager"):
        model = build_model("resnet50", num_classes=10, dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(1))
        eng = Engine(model, 64, device=dev, max_batch=4, bucket_sizes=[4],
                     graphed=name == "graph").start()
        before = _launches()
        rows = [[f.result(60) for f in [eng.submit(i) for i in imgs]] for _ in range(3)]
        torch.cuda.synchronize()
        out[name] = (np.stack(rows[-1]), _delta(before, _launches()))
        assert eng.stats()["n_compiles"] == 1
        eng.drain()
    assert np.array_equal(out["graph"][0], out["eager"][0])
    assert out["graph"][1] == out["eager"][1] and out["graph"][1]["conv_epilogue"] > 0


def test_decode_tile_replay_equals_eager():
    """A tiny GPT (f32, 3 blocks): greedy streams of the graphed engine
    equal the eager one's; each decode step counts one launch a block."""
    from distribuuuu_tpu_torch.lm.generate import GenerateEngine

    dev = _card()
    prompts = [[1, 2, 3], [7, 8], [4, 5, 6, 7, 9]]
    got = {}
    for name in ("graph", "eager"):
        eng = GenerateEngine(_tiny_gpt(torch.float32), device=dev, max_new_tokens=12,
                             prompt_len=8, batch_tiles=[1, 2, 4], cache_tiles=[32],
                             eos_id=-1, graphed=name == "graph").start()
        before = _launches()
        streams = [eng.submit(p) for p in prompts]
        got[name] = ([s.result(60) for s in streams], _delta(before, _launches()),
                     eng.stats()["decode_steps"])
        eng.drain()
    assert got["graph"][0] == got["eager"][0]
    assert got["graph"][1] == got["eager"][1] == {"decode_attn": 3 * got["graph"][2]}


def test_train_step_replays_equal_eager_steps():
    """ResNet-18 (f32, cuDNN deterministic): five graphed steps (the first
    the eager warm-up, then four replays) leave the eager steps' state,
    bit for bit, and count the same launches."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    dev = _card()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), np.uint8)).to(dev),
                "label": torch.from_numpy(rng.integers(0, 10, 8).astype(np.int32)).to(dev)}
               for _ in range(5)]
    state = {}
    for graph in (True, False):
        model = build_model("resnet18", num_classes=10, dtype=torch.float32, bn_group=4,
                            generator=torch.Generator().manual_seed(0)).to(dev).train()
        opt = construct_optimizer(model)
        step = trainer.TrainStep(model, opt, 5, "raise", 1, 1, dev, graphed=graph,
                                 pool=torch.cuda.graph_pool_handle() if graph else None)
        before = _launches()
        losses = [float(step([b], [False])[0, 0]) for b in batches]
        torch.cuda.synchronize()
        state[graph] = ({k: v.clone() for k, v in model.state_dict().items()},
                        [m.clone() for m in opt.m], losses, _delta(before, _launches()))
    (sg, mg, lg, ng), (se, me, le, ne) = state[True], state[False]
    assert lg == le and ng == ne == {"opt_update": 5}
    assert all(torch.equal(sg[k], se[k]) for k in se)
    assert all(torch.equal(a, b) for a, b in zip(mg, me))
