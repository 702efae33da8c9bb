"""The port's grouped 3x3 conv (distribuuuu_tpu_torch/ops/cuda/group_conv.py)
against the JAX package's Pallas kernel, run in interpret mode as
tests/test_group_conv.py runs it, and the site routing of ``ConvBN`` under
``DISTRIBUUUU_GROUP_CONV``.

* The plain version (the CPU path, the kernel's reference on the card)
  equals ``group_conv3x3(..., interpret=True)`` and ``_xla_unrolled`` to
  1e-5 of max(1, max |ref|) in f32 at the JAX test's fast shapes; dx and
  dW through the port's autograd Function equal ``jax.grad`` through the
  Pallas kernel to 1e-4, the JAX test's own tolerance.
* The Function's stride-1 dx is the flipped-weight identity: it equals
  autograd through the plain version.
* The bf16 wgmma body's tiling (``plan``) is pinned at every RegNet
  stage-3 site (regnety_160, regnetx_160, regnety_320 at batches 8, 64,
  200; forward, dx and the stride-2 block), its ring fits the shared
  memory of the blocks an SM holds, and ``kernel_body`` routes by dtype,
  group width and alignment.
* Routing: under ``pallas`` a 3x3, stride-1, padding-1 site at ≤ 14² runs
  the kernel's entry point (its plain version here, on CPU tensors);
  stride 2 and 16² do not; every other mode is the library conv (or the
  block-diagonal dense conv); an unknown value raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_util import few_threads

from distribuuuu_tpu.ops.group_conv import _xla_unrolled
from distribuuuu_tpu.ops.group_conv import group_conv3x3 as jax_group_conv3x3
from distribuuuu_tpu_torch.models.layers import BatchNorm, ConvBN, block_diagonal, conv2d
from distribuuuu_tpu_torch.ops.cuda import group_conv as gc

# (B, H, W, C, G, stride): tests/test_group_conv.py's fast shapes (its
# stride-2 G=11 16² shape is marked slow there and left out here)
SHAPES = [(4, 14, 14, 33, 3, 1), (2, 8, 8, 16, 4, 1), (4, 8, 8, 16, 2, 2)]


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _inputs(shape, seed=0):
    b, h, w, c, g, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c // g, c)) * 0.1).astype(np.float32)
    return x, k


def _port_weight(k: np.ndarray) -> torch.Tensor:
    """JAX [3, 3, cg, C_out] → the port's [C_out, cg, 3, 3], channels last."""
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).contiguous(
        memory_format=torch.channels_last)


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(np.asarray(got) - want).max()) <= tol * scale


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_the_pallas_kernel_in_interpret_mode(shape):
    *_, g, s = shape
    x, k = _inputs(shape)
    got = gc.group_conv3x3_plain(torch.from_numpy(x), _port_weight(k), s, g).numpy()
    _close(got, jax_group_conv3x3(jnp.asarray(x), jnp.asarray(k), s, g, True), 1e-5)
    _close(got, _xla_unrolled(jnp.asarray(x), jnp.asarray(k), s, g), 1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_grads_match_jax_grad_through_the_pallas_kernel(shape):
    *_, g, s = shape
    x, k = _inputs(shape, seed=1)
    jdx, jdw = jax.grad(
        lambda xx, kk: jnp.sum(jax_group_conv3x3(xx, kk, s, g, True) ** 2), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tw = _port_weight(k).requires_grad_()
    dx, dw = torch.autograd.grad(gc.group_conv3x3(tx, tw, s, g).square().sum(), (tx, tw))
    _close(dx.numpy(), jdx, 1e-4)
    _close(dw.permute(2, 3, 1, 0).numpy(), jdw, 1e-4)
    assert gc.group_conv3x3.launches == gc.group_conv3x3.launches_dx == 0  # CPU: no kernel


@pytest.mark.parametrize("g,cg,fg", [(3, 11, 11), (4, 8, 6), (1, 5, 7)])
def test_flipped_weight_dx_equals_autograd_through_the_plain_version(g, cg, fg):
    """dx of the Function (the conv of dy with ``flipped_weight``) against
    autograd through ``group_conv3x3_plain``, fg != cg included."""
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6, g * cg))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((g * fg, cg, 3, 3)) * 0.2)
    dy = torch.from_numpy(rng.standard_normal((2, 7, 6, g * fg)))
    (want,) = torch.autograd.grad(gc.group_conv3x3_plain(x, w, 1, g), x, dy)
    (got,) = torch.autograd.grad(gc.group_conv3x3(x, w, 1, g), x, dy)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    flip = gc.flipped_weight(w, g)
    assert flip.shape == (g * cg, fg, 3, 3)
    torch.testing.assert_close(gc.flipped_weight(flip, g), w.contiguous(
        memory_format=torch.channels_last), rtol=0, atol=0)  # an involution


def test_plain_rounds_once_to_the_input_dtype():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 5, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8, 3, 3)).astype(np.float32))
    want = gc.group_conv3x3_plain(x.double(), w.double(), 1, 2)
    got = gc.group_conv3x3_plain(x.bfloat16(), w.bfloat16(), 1, 2)
    assert got.dtype == torch.bfloat16
    ref = gc.group_conv3x3_plain(x.bfloat16().double(), w.bfloat16().double(), 1, 2)
    torch.testing.assert_close(got, ref.bfloat16(), rtol=0, atol=0)
    assert float((got.double() - want).abs().max()) < 0.5


def test_geometry_is_checked():
    x = torch.zeros(1, 4, 4, 6)
    with pytest.raises(ValueError, match="groups=4"):
        gc.group_conv3x3_plain(x, torch.zeros(6, 2, 3, 3), 1, 4)
    with pytest.raises(ValueError, match="stride 3"):
        gc.group_conv3x3_plain(x, torch.zeros(6, 2, 3, 3), 3, 3)
    with pytest.raises(ValueError, match="3, 3"):
        gc.group_conv3x3_plain(x, torch.zeros(6, 2, 1, 1), 1, 3)


@pytest.mark.parametrize("k,s,pad,hw,ok", [
    ((3, 3), 1, [(1, 1), (1, 1)], (14, 14), True),
    ((3, 3), 1, [(1, 1), (1, 1)], (7, 14), True),
    ((3, 3), 2, [(1, 1), (1, 1)], (14, 14), False),
    ((3, 3), 1, [(1, 1), (1, 1)], (16, 14), False),
    ((3, 3), 1, [(0, 0), (0, 0)], (8, 8), False),
    ((1, 1), 1, [(0, 0), (0, 0)], (8, 8), False),
])
def test_qualifies_is_the_jax_gate(k, s, pad, hw, ok):
    got, reason = gc.qualifies(k, s, pad, *hw)
    assert got is ok and (reason == "") is ok


def test_bound_counts_at_regnety_160_stage_3():
    """2·B·196·9·cg·C operations; x read, the weight read, out written."""
    flops = gc.pass_flops(8, 14, 14, 1232, 112, 1)
    nbytes = gc.pass_bytes(8, 14, 14, 1232, 1232, 112, 1, torch.bfloat16)
    assert flops == 2 * 8 * 196 * 9 * 112 * 1232 and round(flops / 1e9, 2) == 3.89
    assert round(nbytes / 1e6, 1) == 10.2


# (arch, batch) -> the plan at its stage-3 grouped 3x3 (14² out, the sites
# DISTRIBUUUU_GROUP_CONV=pallas sends to the kernel), as measured on the
# H100 with group_conv_sweep.py: (warpgroups, stages)
STAGE3_PLANS = {
    ("regnety_160", 8): (1, 5), ("regnety_160", 64): (2, 7), ("regnety_160", 200): (2, 7),
    ("regnetx_160", 8): (1, 4), ("regnetx_160", 64): (1, 4), ("regnetx_160", 200): (1, 4),
    ("regnety_320", 8): (1, 6), ("regnety_320", 64): (2, 5), ("regnety_320", 200): (2, 5),
}


@pytest.mark.parametrize("arch,batch", list(STAGE3_PLANS), ids=str)
def test_plan_is_pinned_at_every_regnet_stage_3_site(arch, batch):
    """The wgmma body's tiling at each RegNet's stage 3, read off the model:
    the stride-1 blocks (forward, and dx on the flipped weight, whose cg
    and fg trade places) and the stride-2 first block (28² in, 14² out)."""
    from distribuuuu_tpu_torch.models import build_model

    stage = build_model(arch, device="meta").stages[2]
    want = gc.GroupPlan(*STAGE3_PLANS[(arch, batch)])
    seen = set()
    for blk in stage:
        conv = blk.conv2.conv
        g, s = conv.groups, conv.stride[0]
        cg, fg = conv.in_channels // g, conv.out_channels // g
        seen.add(s)
        assert gc.plan(batch * 14 * 14, g, cg, fg, s) == want
        if s == 1:
            assert gc.plan(batch * 14 * 14, g, fg, cg, 1) == want  # the dx conv
    assert seen == {1, 2}


@pytest.mark.parametrize("wg", [1, 2])
@pytest.mark.parametrize("fg", [16, 48, 112, 128, 232])
def test_plan_stages_fit_the_blocks_an_sm_holds(wg, fg):
    """The ring a plan takes fits in shared memory as the launcher lays it
    out (1 KB of alignment, then a stage of A and B rows of 128 bytes and
    16 bytes of barriers each), for the blocks an SM holds; one stage more
    would not."""
    per_sm = gc.blocks_per_sm(wg, fg)
    n = gc.max_stages(wg, fg, per_sm)
    stage = (64 * wg + gc.n_tile(fg)) * 128 + 16
    budget = gc.MAX_SMEM if per_sm == 1 else gc.SM_SMEM // per_sm - 1024
    assert n >= 1 and 1024 + n * stage <= budget < 1024 + (n + 1) * stage
    assert gc.n_tile(fg) == (fg if fg != 48 else 64)


def test_plan_takes_no_more_stages_than_k_steps():
    assert gc.plan(8 * 196, 32, 16, 16, 1) == gc.GroupPlan(1, 3)  # ResNeXt: 9·16 = 3 steps of 64


def test_kernel_body_routes_by_dtype_width_and_alignment():
    """bf16 with cg and fg multiples of 8 and 16-byte aligned bases takes
    the wgmma body; cg 11 or a base one element off alignment takes the
    mma.sync body; f32 its own."""
    x = torch.zeros(2, 6, 6, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 8, 3, 3, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert gc.kernel_body(x, w, 4) == "wgmma"
    assert gc.kernel_body(x.float(), w.float(), 4) == "f32"
    assert gc.kernel_body(x[..., :22], torch.zeros(22, 11, 3, 3, dtype=torch.bfloat16),
                          2) == "mma_sync"
    off = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert gc.kernel_body(off, w, 4) == "mma_sync"


def _unit(groups=4, stride=1, c=16):
    torch.manual_seed(0)
    conv = conv2d(c, c, 3, stride, groups)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(c)
    bn.eval()
    return ConvBN(conv, bn, F.relu, torch.float32)


def _spy(monkeypatch):
    calls = []
    real = gc.group_conv3x3_plain
    monkeypatch.setattr(gc, "group_conv3x3_plain",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    return calls


def _library(unit, x):
    c = unit.conv
    y = F.conv2d(x.permute(0, 3, 1, 2), c.weight, None, c.stride, c.padding, 1, c.groups)
    return torch.relu(unit.bn(y.permute(0, 2, 3, 1), torch.float32))


@pytest.mark.parametrize("mode", ["auto", "unrolled", "fused", "blockdiag", "pallas"])
def test_convbn_routes_grouped_sites_by_the_switch(monkeypatch, mode):
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", mode)
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    for stride, hw, kernel in ((1, 14, True), (1, 16, False), (2, 14, False)):
        unit = _unit(stride=stride)
        x = torch.from_numpy(rng.standard_normal((2, hw, hw, 16)).astype(np.float32))
        calls.clear()
        with torch.no_grad():
            got = unit(x)
        assert unit.group_kernel(hw, hw) is (kernel and mode == "pallas")
        assert calls == ([(2, hw, hw, 16)] if unit.group_kernel(hw, hw) else [])
        torch.testing.assert_close(got, _library(unit, x), rtol=1e-5, atol=1e-5)


def test_convbn_reads_the_switch_when_built(monkeypatch):
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "pallas")
    unit = _unit()
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "auto")
    assert unit.group_mode == "pallas" and unit.group_kernel(14, 14)
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "nonsense")
    with pytest.raises(ValueError, match="DISTRIBUUUU_GROUP_CONV='nonsense'"):
        _unit()
    assert _unit(groups=1).group_mode is None  # an ungrouped conv never reads it


def test_training_site_under_pallas_takes_the_kernel_forward_and_dx(monkeypatch):
    """A train-mode site: the forward and the stride-1 dx both go through
    the grouped conv's entry point; gradients equal the library conv's."""
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "pallas")
    calls = _spy(monkeypatch)
    unit = _unit()
    unit.bn.train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 6, 6, 16))
                         .astype(np.float32)).requires_grad_()
    w = unit.conv.weight
    got = torch.autograd.grad(unit(x).square().sum(), (x, w))
    assert len(calls) == 2  # the forward and the dx
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "auto")
    ref_unit = ConvBN(unit.conv, unit.bn, F.relu, torch.float32)
    want = torch.autograd.grad(ref_unit(x).square().sum(), (x, w))
    assert len(calls) == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_block_diagonal_weight():
    w = torch.arange(2 * 3 * 2 * 9, dtype=torch.float32).reshape(6, 2, 3, 3)
    d = block_diagonal(w, 2)
    assert d.shape == (6, 4, 3, 3)
    assert torch.equal(d[:3, :2], w[:3]) and torch.equal(d[3:, 2:], w[3:])
    assert not d[:3, 2:].any() and not d[3:, :2].any()
