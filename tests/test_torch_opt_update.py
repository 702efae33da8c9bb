"""The port's fused optimizer update (ops/cuda/opt_update.py) against the
JAX kernel (distribuuuu_tpu/ops/pallas/opt_update.py, ``interpret=True``
under ``jax.jit``, as tests/test_pallas_kernels.py runs it on the CPU).

On the CPU the port's ``update`` runs its plain version. The target is bit
equality of params and moments over three steps, for every body: SGD with
an f32 trace (with and without Nesterov), with a bf16 trace, without
momentum, and AdamW. Every body reaches it: XLA contracts ``a·b + c`` into
a fused multiply-add at fixed sites and reassociates AdamW's divisions,
and the plain version reproduces both (module docstring of the port).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, jax_resnet, random_variables

from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.ops.pallas import opt_update as ou
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch.ops.cuda import opt_update
from distribuuuu_tpu_torch.utils.optim import Optimizer
from distribuuuu_tpu_torch.utils.weights import opt_state_from_jax

SHAPES = {"w": (37, 13), "b": (5,), "big": (700_000,)}  # tests/test_pallas_kernels.py
LR = (0.1, 0.1, 0.05)  # the third step changes the learning rate

CASES = {
    "sgd_nesterov_f32": dict(kind="sgd", mom=0.9, nesterov=True, mdt="float32"),
    "sgd_f32": dict(kind="sgd", mom=0.9, nesterov=False, mdt="float32"),
    "sgd_nesterov_bf16": dict(kind="sgd", mom=0.9, nesterov=True, mdt="bfloat16"),
    "sgd_f32_no_momentum": dict(kind="sgd", mom=0.0, nesterov=True, mdt="float32"),
    "adamw": dict(kind="adamw", mom=0.9, nesterov=True, mdt="float32"),
}


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in SHAPES.items()}
             for sc in (0.1, 1.0, 0.01)]
    return params, grads


def _jax_steps(case, params, grads):
    jcfg.defrost()
    jcfg.OPTIM.OPTIMIZER = case["kind"]
    jcfg.OPTIM.MOMENTUM = case["mom"]
    jcfg.OPTIM.NESTEROV = case["nesterov"]
    jcfg.OPTIM.MOMENTUM_DTYPE = case["mdt"]
    opt = jax_construct_optimizer()
    state = opt.init(jax.tree.map(jnp.asarray, params))
    step = jax.jit(lambda p, g, s: ou.fused_optimizer_update(
        p, g, s, kind=case["kind"], wd=float(jcfg.OPTIM.WEIGHT_DECAY),
        mom=float(jcfg.OPTIM.MOMENTUM), nesterov=bool(jcfg.OPTIM.NESTEROV),
        b1=float(jcfg.OPTIM.BETA1), b2=float(jcfg.OPTIM.BETA2), eps=1e-8,
        interpret=True,
    ))
    p, out = params, []
    for lr, g in zip(LR, grads):
        state.hyperparams["learning_rate"] = lr
        p, state = step(p, g, state)
        out.append((jax.tree.map(np.asarray, p), state))
    return out


def _moments(state, kind):
    if kind == "adamw":
        adam = state.inner_state[0]
        return adam.mu, adam.nu
    tr = ou._find_state(state.inner_state, "trace")
    return (tr[0].trace if tr else None), None


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_update_plain_bit_equal_to_jitted_jax_kernel(name):
    case = CASES[name]
    params, grads = _inputs()
    ref = _jax_steps(case, params, grads)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    h = opt_update.Hyper(kind=case["kind"], wd=5e-5, mom=case["mom"] if case["kind"] == "sgd"
                         else 0.0, nesterov=case["nesterov"], b1=0.9, b2=0.999, eps=1e-8)
    opt = Optimizer(list(tp.items()), h, LR[0],
                    torch.bfloat16 if case["mdt"] == "bfloat16" else torch.float32)
    for i, (lr, g) in enumerate(zip(LR, grads)):
        opt.lr = lr
        launches = opt_update.update.launches
        opt.step([torch.from_numpy(g[k]) for k in tp])
        assert opt_update.update.launches == launches  # CPU tensors: plain version
        jp, jstate = ref[i]
        jm, jv = _moments(jstate, case["kind"])
        for k, t in tp.items():
            np.testing.assert_array_equal(t.numpy().view(np.int32), jp[k].view(np.int32),
                                          err_msg=f"{name} step {i + 1} param {k}")
            j = list(tp).index(k)
            if jm is None:
                assert opt.m is None
            else:
                assert opt.m[j].dtype == (torch.bfloat16 if case["mdt"] == "bfloat16"
                                          else torch.float32)
                np.testing.assert_array_equal(
                    _bits(opt.m[j]), np.asarray(jm[k]).astype(np.float32).view(np.int32),
                    err_msg=f"{name} step {i + 1} moment {k}")
            if jv is not None:
                np.testing.assert_array_equal(_bits(opt.v[j]),
                                              np.asarray(jv[k]).view(np.int32))
    assert opt.count == int(ref[-1][1].count) == 3


def test_bf16_trace_decays_by_the_rounded_momentum():
    """bf16(0.9) = 0.8984375 multiplies the bf16 trace; the Nesterov step
    uses f32 0.9 on the unrounded f32 trace."""
    s = opt_update.scalars(opt_update.Hyper(kind="sgd", mom=0.9), 0.1, 1, torch.bfloat16)
    assert s["mom_t"] == 0.8984375 and s["mom"] == float(np.float32(0.9))
    p = torch.zeros(1)
    t = torch.tensor([3.0], dtype=torch.bfloat16)
    h = opt_update.Hyper(kind="sgd", mom=0.9, nesterov=True)
    opt_update.update_plain([p], [torch.zeros(1)], [t], None, h,
                            opt_update.staged_scalars(h, 0.0, 1, [p], [t]))
    assert float(t) == 2.6875  # bf16(0.8984375 · 3) = bf16(2.6953125)


def test_bias_correction_matches_jax():
    f = jax.jit(lambda c: (1 - 0.9 ** c, 1 - 0.999 ** c))
    h = opt_update.Hyper(kind="adamw")
    for t in (1, 2, 7, 100, 1001, 50_000):
        c1, c2 = (float(np.asarray(v)) for v in f(jnp.int32(t)))
        s = opt_update.scalars(h, 0.1, t)
        assert (s["c1"], s["c2"]) == (c1, c2), t


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_opt_state_from_jax(mdt):
    """A mid-run optax state over a JAX ResNet carries into the port's
    optimizer by parameter name, layout and count."""
    jcfg.defrost()
    jcfg.OPTIM.MOMENTUM_DTYPE = mdt
    _, shapes = jax_resnet("resnet18")
    params = random_variables(shapes, seed=3)["params"]
    opt = jax_construct_optimizer()
    state = opt.init(params)
    grads = jax.tree.map(lambda p: p * 0.5, params)
    for _ in range(2):
        _, state = jax.jit(opt.update)(grads, state, params)
    sd = opt_state_from_jax(state, params)
    assert sd["count"] == 2 and sd["v"] is None
    trace = ou._find_state(state.inner_state, "trace")[0].trace
    k = trace["ConvBN_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(sd["m"]["conv1.weight"],
                                  np.asarray(k).astype(np.float32).transpose(3, 2, 0, 1))
    from distribuuuu_tpu_torch import models as tmodels

    model = tmodels.build_model("resnet18", num_classes=10)
    port = Optimizer(list(model.named_parameters()), opt_update.Hyper(kind="sgd", mom=0.9),
                     0.1, torch.bfloat16 if mdt == "bfloat16" else torch.float32)
    port.load_state_dict(sd)
    assert port.count == 2
    got = port.m[port.names.index("fc.weight")]
    want = np.asarray(trace["Dense_0"]["Dense_0"]["kernel"]).astype(np.float32).T
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (np.asarray(k).dtype == ml_dtypes.bfloat16) == (mdt == "bfloat16")

    jcfg.OPTIM.OPTIMIZER = "adamw"
    aopt = jax_construct_optimizer()
    astate = aopt.init(params)
    _, astate = jax.jit(aopt.update)(grads, astate, params)
    asd = opt_state_from_jax(astate, params)
    assert asd["count"] == 1 and set(asd["m"]) == set(asd["v"]) == set(port.names)
