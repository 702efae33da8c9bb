"""Tests of the port that need the card (marker ``cuda``; they skip without
CUDA). No JAX here, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The conv-epilogue kernel is held against its plain version (tolerances
as in tests/test_torch_conv_epilogue.py) at a shape for every plan of its
bf16 TMA/wgmma body, at ragged edges and in its mma.sync body; a split-K
shape gives the same bits twice and on two streams; and a small ResNet-50 is served
on the card through the engine, every fused site launching the kernel.
The fused optimizer update is held bit for bit against its plain version
for each body, and a train step launches it exactly once. The three
flash-attention kernels are held against their plain versions at ragged
lengths, causal and not, in bf16 and f32; the gradients through the
autograd Function on the card against the same Function on the CPU; and
each launch counter moves once per call. The decode-attention kernel is
held against its plain version at head dims 32/64/128 in bf16 and f32, a
decode step of the generation engine launches it once per block, and the
engine's f32 greedy streams on the card equal the CPU's. The grouped 3x3
conv kernel is held against its plain version at the RegNets' stage-3
shapes, a ResNeXt shape, a stride-2 shape and a ragged one, in bf16 and
f32; its autograd dx and dW on the card against the CPU's.
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
        ou.update(kp, grads, km, kv, h, 0.1 / step, step)
        ou.update_plain(p, grads, m, v, h, 0.1 / step, step)
    torch.cuda.synchronize()
    assert ou.update.launches == before + 3
    for got, want in zip([*kp, *(km or []), *(kv or [])], [*p, *(m or []), *(v or [])]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_opt_update_refuses_what_it_does_not_take():
    dev = _card()
    h = ou.Hyper(kind="sgd", mom=0.9)
    p, gr = torch.zeros(4, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(TypeError, match="f32 params"):
        ou.update([p.double()], [gr.double()], [p.double()], None, h, 0.1, 1)
    with pytest.raises(ValueError, match="on cpu"):
        ou.update([p], [gr.cpu()], [p.clone()], None, h, 0.1, 1)
    with pytest.raises(TypeError, match="moment"):
        ou.update([p], [gr], [p.half()], None, h, 0.1, 1)


FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}  # of the reference's scale


def _flash_inputs(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(4)]


def _close(got, want, tol):
    scale = max(float(want.float().abs().max()), 1.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,L,d", [(6, 150, 64), (3, 70, 32), (2, 200, 128)])
def test_flash_kernels_match_plain_on_card(dtype, causal, bh, L, d):
    """Each of the three kernels against its plain version on the same
    inputs, at ragged lengths (masked key and query tails)."""
    dev = _card()
    q, k, v, do = _flash_inputs(dev, (bh, L, d), dtype)
    scale = d ** -0.5
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
def test_flash_gradients_on_card_match_the_cpu(causal):
    """Gradients through the autograd Function on the card (the kernels)
    against the same Function on the CPU (the plain versions), f32, with a
    head dim the kernels pad (40 → 64) and an lse cotangent."""
    dev = _card()
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 3, 97, 40)).astype(np.float32) for _ in range(5)]
    g_lse = rng.standard_normal((2, 3, 97)).astype(np.float32)
    grads = []
    for device in (dev, torch.device("cpu")):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True) for a in arrs[:3])
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        loss = (o * torch.tensor(arrs[3], device=device)).sum() + \
            (lse * torch.tensor(g_lse, device=device)).sum()
        grads.append([t.detach().cpu() for t in (o, lse, *torch.autograd.grad(loss, (q, k, v)))])
    for got, want in zip(*grads):
        _close(got, want, 1e-5)


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
