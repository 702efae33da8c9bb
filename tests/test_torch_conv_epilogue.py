"""The port's fused conv epilogue (distribuuuu_tpu_torch/ops/cuda/conv_epilogue.py)
against the JAX Pallas kernel (ops/pallas/conv_epilogue.py, interpret mode).

On the CPU the port's wrapper runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py. Tolerances are
the JAX test's pinned ones (tests/test_pallas_kernels.py): f32 1e-5 and
bf16 0.0625 max-abs — the fused accumulator stays fp32 into the affine,
so bf16 outputs agree to bf16 rounding.
"""

from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distribuuuu_tpu.ops.pallas import conv_epilogue as jce
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as tce

TOL = {"float32": 1e-5, "bfloat16": 0.0625}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (x shape, Cout): the JAX test's shape, and one whose M (105), K (37) and
# N (53) are ragged against every tile of both kernels
SHAPES = [((2, 5, 5, 48), 96), ((3, 7, 5, 37), 53)]


def _inputs(shape, cout, seed=4):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((1, 1, cin, cout)) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    var = (rng.random(cout) + 0.3).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.3 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    inv = (1.0 / np.sqrt(var + 1e-5) * scale).astype(np.float32)
    return x, k, inv, (bias - mean * inv).astype(np.float32)


@pytest.mark.parametrize("act", ["id", "relu", "silu"])
@pytest.mark.parametrize("shape,cout", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_pallas_kernel(dtype, shape, cout, act):
    x, k, a, c = _inputs(shape, cout)
    ref = jce.conv1x1_bn_act(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(k, JDT[dtype]),
        jnp.asarray(a), jnp.asarray(c), act, interpret=True,
    )
    got = tce.conv1x1_bn_act(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(k).to(TDT[dtype]),
        torch.from_numpy(a), torch.from_numpy(c), act,
    )
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (*shape[:-1], cout)
    d = np.abs(np.asarray(ref, np.float32) - got.float().numpy()).max()
    assert d <= TOL[dtype], d


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    x, k, a, c = _inputs((2, 3, 3, 8), 16)
    before = tce.conv1x1_bn_act.launches
    args = (torch.from_numpy(x), torch.from_numpy(k[0, 0]), torch.from_numpy(a),
            torch.from_numpy(c), "relu")
    out = tce.conv1x1_bn_act(*args, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tce.conv1x1_bn_act_plain(*args, out_dtype=torch.bfloat16))
    assert tce.conv1x1_bn_act.launches == before


def test_no_silent_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA has no path: the
    tier raises instead of quietly computing somewhere else."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel or plain version"):
        tce.conv1x1_bn_act(x, torch.empty((8, 4), device="meta"),
                           torch.empty(4, device="meta"), torch.empty(4, device="meta"))


def test_unknown_act_raises():
    x, k, a, c = _inputs((1, 2, 2, 4), 4)
    with pytest.raises(ValueError, match="unknown act"):
        tce.conv1x1_bn_act(torch.from_numpy(x), torch.from_numpy(k),
                           torch.from_numpy(a), torch.from_numpy(c), "gelu")


def my_softplus(x):
    return x


# (kernel_size, strides, padding, groups, act (jax, port), train)
QUALIFY_CASES = [
    ((1, 1), 1, [(0, 0), (0, 0)], 1, (None, None), False),
    ((1, 1), (1, 1), None, 1, (nn.relu, F.relu), False),
    ((1, 1), 1, [(0, 0), (0, 0)], 1, (nn.silu, F.silu), False),
    ((1, 1), 1, [(0, 0), (0, 0)], 1, (None, None), True),
    ((3, 3), 1, [(1, 1), (1, 1)], 1, (nn.relu, F.relu), False),
    ((1, 1), 2, [(0, 0), (0, 0)], 1, (None, None), False),
    ((1, 1), (1, 2), [(0, 0), (0, 0)], 1, (None, None), False),
    ((1, 1), 1, [(1, 1), (0, 0)], 1, (None, None), False),
    ((1, 1), 1, [(0, 0), (0, 0)], 4, (None, None), False),
    ((1, 1), 1, [(0, 0), (0, 0)], 1, (my_softplus, my_softplus), False),
]


@pytest.mark.parametrize("case", QUALIFY_CASES, ids=lambda c: repr(c[:4]) + str(c[5]))
def test_qualifies_matches_jax(case):
    k, s, p, g, (jact, tact), train = case
    assert tce.qualifies(k, s, p, g, tact, train) == jce.qualifies(k, s, p, g, jact, train)


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_pass_bytes_matches_jax(dtypes):
    i, o = dtypes
    assert tce.pass_bytes(392, 2048, 512, TDT[i], TDT[o]) == jce.pass_bytes(
        392, 2048, 512, JDT[i], JDT[o])


def test_act_registry():
    assert tce.act_code(None) == "id"
    assert tce.act_code(F.relu) == "relu"
    assert tce.act_code(torch.relu) == "relu"
    assert tce.act_code(F.silu) == "silu"
    assert tce.act_code(my_softplus) is None


def test_kernel_knob_accepts_only_auto():
    kernel_tier.validate_kernels_cfg(tcfg.KERNELS)
    for bad in ("xla", "pallas", "torch", "cuda"):
        with pytest.raises(ValueError, match="accepts only"):
            kernel_tier.validate_kernels_cfg({"CONV_EPILOGUE": bad})
