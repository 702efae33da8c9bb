"""Train-mode BatchNorm of the port (models/layers.BatchNorm) against the
flax BatchNorm of the JAX package (``_BNCore``, ``mutable=["batch_stats"]``):
the output, the gradients for x, scale and bias (``jax.vjp`` against
``torch.autograd``), and the updated running stats. One group and ghost
groups, the three ``DISTRIBUUUU_BN_VARIANCE`` modes, a nonzero running
mean (the shift of the default one-pass form).

f64 agrees to 1e-12 (only the order of the sums differs). f32 agrees to
2e-5 relative on the outputs and gradients and 1e-6 on the running stats:
XLA and PyTorch sum the statistics in different orders and XLA contracts
``m·ra + (1−m)·upd`` into a fused multiply-add.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads

from distribuuuu_tpu.models import layers as jlayers
from distribuuuu_tpu_torch.models.layers import BatchNorm

TOL = {"float64": dict(rtol=1e-12, atol=1e-12), "float32": dict(rtol=2e-5, atol=2e-5)}
STAT_TOL = {"float64": dict(rtol=1e-12, atol=1e-12), "float32": dict(rtol=1e-6, atol=1e-6)}


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _case(dtype, seed=0, n=8, c=6):
    rng = np.random.default_rng(seed)
    x = (1.5 + rng.standard_normal((n, 4, 4, c)) * 2.0).astype(dtype)
    dy = rng.standard_normal(x.shape).astype(dtype)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(dtype)
    bias = (0.1 * rng.standard_normal(c)).astype(dtype)
    mean = (1.2 + 0.1 * rng.standard_normal(c)).astype(dtype)  # near the batch mean
    var = rng.uniform(0.5, 2.0, c).astype(dtype)
    return x, dy, scale, bias, mean, var


def _jax(x, dy, scale, bias, mean, var, gs, dtype):
    bn = jlayers.BatchNorm(dtype=jnp.dtype(dtype), group_size=gs)
    stats = {"BatchNorm_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    def f(x, scale, bias):
        v = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}}, "batch_stats": stats}
        return bn.apply(v, x, train=True, mutable=["batch_stats"])

    y, vjp, upd = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          has_aux=True)
    return y, upd["batch_stats"]["BatchNorm_0"], vjp(jnp.asarray(dy))


def _port(x, dy, scale, bias, mean, var, gs, dtype):
    tdt = getattr(torch, dtype)
    bn = BatchNorm(x.shape[-1], group_size=gs).to(tdt).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, tdt)
    y.backward(torch.from_numpy(dy))
    return y.detach(), bn, (xt.grad, bn.weight.grad, bn.bias.grad)


@pytest.mark.parametrize("mode", ["shifted", "centered", "uncentered"])
@pytest.mark.parametrize("gs", [0, 4, 8])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_train_bn_matches_flax(request, monkeypatch, mode, gs, dtype):
    if dtype == "float64":
        request.getfixturevalue("x64")
    monkeypatch.setenv("DISTRIBUUUU_BN_VARIANCE", mode)
    args = _case(np.dtype(dtype))
    jy, jstats, jgrads = _jax(*args, gs, dtype)
    ty, bn, tgrads = _port(*args, gs, dtype)
    assert ty.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL[dtype])
    for name, t, j in zip(("x", "scale", "bias"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL[dtype])
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]),
                               **STAT_TOL[dtype])
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]),
                               **STAT_TOL[dtype])
    assert bn.running_mean.dtype == getattr(torch, dtype)


def test_ghost_groups_differ_from_one_group_and_indivisible_batch_raises():
    x, dy, *rest = _case(np.float64)
    y_all = _port(x, dy, *rest, 0, "float64")[0]
    y_g4 = _port(x, dy, *rest, 4, "float64")[0]
    assert not torch.allclose(y_all, y_g4)
    with pytest.raises(ValueError, match="does not divide batch 8"):
        _port(x, dy, *rest, 3, "float64")


def test_momentum_override_and_bf16_output(monkeypatch):
    monkeypatch.setenv("DISTRIBUUUU_BN_MOMENTUM", "0.5")
    x, dy, scale, bias, mean, var = _case(np.float32)
    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
    y = bn(torch.from_numpy(x).bfloat16(), torch.bfloat16)
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    batch_mean = torch.from_numpy(x).bfloat16().float().mean((0, 1, 2))
    torch.testing.assert_close(bn.running_mean, 0.5 * torch.from_numpy(mean) + 0.5 * batch_mean)
