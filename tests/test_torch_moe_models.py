"""The MoE archs (``vit_tiny_moe``, ``gpt_nano_moe``) of the port against the
JAX package's, narrow (2-4 blocks, dim 32, 4 experts), on numpy-seeded
weights carried by ``state_dict_from_jax``: logits and the loss with the
balancing aux, a 3-step lockstep, the parameter counts at full width, and
greedy tokens from the MoE decoder.

Tolerances. At f32 the logits agree to 1e-5 of their scale (sums in other
orders). At f64 both packages still compute two regions in f32 (the MoE
router, JAX ``ops/moe.py:72``, and the dense attention scores, JAX
``models/vit.py:356``), where XLA's and PyTorch's f32 ulps differ, so f64
logits, losses and the 3-step lockstep agree to 1e-6 relative, not 1e-10;
each comparison first asserts that the first MoE block routed every token
to the same experts on both sides. ``tests/test_torch_tp_ep.py`` holds the
port's sharded runs against its own unsharded run at 1e-10.
"""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, random_variables, reset_port_cfg

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.lm import generate as jgen
from distribuuuu_tpu.ops import moe as jmoe
from distribuuuu_tpu.parallel.partition.lowering import TrainState, make_train_step
from distribuuuu_tpu.utils.metrics import cross_entropy as jax_ce
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import config as tconfig
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.lm import generate as tgen
from distribuuuu_tpu_torch.models.gpt import GPT
from distribuuuu_tpu_torch.models.vit import ViT
from distribuuuu_tpu_torch.ops import moe as tmoe
from distribuuuu_tpu_torch.utils.metrics import cross_entropy
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

IM, SEQ, CLASSES, VOCAB = 32, 16, 10, 320
NARROW = dict(dim=32, depth=4, num_heads=2, moe_experts=4)
F32, F64 = 1e-5, 1e-6  # relative to the logit scale (module docstring)
AUX = 0.01
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield from few_threads()
    reset_port_cfg()


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_model(arch: str, dtype):
    if arch == "gpt":
        return jmodels.build_model("gpt_nano_moe", num_classes=VOCAB, dtype=dtype, seq_len=SEQ,
                                   **NARROW)
    return jmodels.build_model("vit_tiny_moe", num_classes=CLASSES, dtype=dtype, **NARROW)


def _dummy(arch: str):
    return (jnp.zeros((2, 8), jnp.int32) if arch == "gpt"
            else jnp.zeros((1, IM, IM, 3), jnp.float32))


@functools.lru_cache(maxsize=None)
def _carry(arch: str):
    """(arch, numpy variables) of the narrow MoE model."""
    jm = _jax_model(arch, jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, _dummy(arch), train=False),
                            jax.random.key(0))
    return arch, random_variables(nn.unbox(shapes)["params"], seed=3)


@pytest.fixture(params=["vit", "gpt"])
def carried(request):
    return _carry(request.param)


def _port(arch: str, params: dict, dtype) -> torch.nn.Module:
    if arch == "gpt":
        model = GPT(vocab_size=VOCAB, seq_len=SEQ, dtype=dtype, **NARROW)
    else:
        model = ViT(num_classes=CLASSES, dtype=dtype, img_size=IM, **NARROW)
    model = model.to(dtype if dtype == torch.float64 else torch.float32)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _batch(arch: str, step: int = 0, n: int = 4) -> dict:
    rng = np.random.default_rng(100 + step)
    if arch == "gpt":
        toks = rng.integers(0, VOCAB, (n, SEQ + 1)).astype(np.int32)
        return {"image": toks[:, :-1], "label": toks[:, 1:]}
    return {"image": rng.standard_normal((n, IM, IM, 3)),
            "label": rng.integers(0, CLASSES, n).astype(np.int32)}


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _routing_agrees(arch, jm, jparams, model, x) -> None:
    """The first MoE block (Block_1) routes every token to the same top-k
    experts on both sides."""
    _, st = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, train=True,
                                           capture_intermediates=True,
                                           mutable=["intermediates"]))(jparams, x)
    jin = st["intermediates"]["Block_1"]["LayerNorm_1"]["__call__"][0]
    d = jin.shape[-1]
    _, jidx = jmoe.top_k_gating(jin.reshape(-1, d), jparams["Block_1"]["MoeMlp_0"]["gate"], 2)
    seen = []
    h = model.blocks[1].mlp.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    model(torch.from_numpy(np.array(x)))
    h.remove()
    _, tidx = tmoe.top_k_gating(seen[0].reshape(-1, d), model.blocks[1].mlp.gate, 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} of the scale > {rtol}"


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_logits_and_loss_with_aux(carried, precision, request):
    arch, variables = carried
    if precision == "f64":
        request.getfixturevalue("x64")
    jdt, tdt, tol = ((jnp.float64, torch.float64, F64) if precision == "f64"
                     else (jnp.float32, torch.float32, F32))
    np_dt = np.float64 if precision == "f64" else np.float32
    jm = _jax_model(arch, jdt)
    params = _cast(variables, np_dt)
    b = _batch(arch)
    x = jnp.asarray(b["image"] if arch == "gpt" else b["image"].astype(np_dt))
    model = _port(arch, variables, tdt).train()
    _routing_agrees(arch, jm, params, model, x)
    logits, mut = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, train=True,
                                                 mutable=["intermediates"]))(params, x)
    aux = jax.tree.leaves(mut["intermediates"])
    assert len(aux) == NARROW["depth"] // 2
    want_loss = jax_ce(logits, jnp.asarray(b["label"])) + AUX * sum(aux) / len(aux)
    got = model(torch.from_numpy(np.array(x)))
    moe = model.moe_layers()
    got_loss = cross_entropy(got, torch.from_numpy(b["label"])) + AUX * sum(
        m.aux for m in moe) / len(moe)
    _close(got.detach(), logits, tol, "logits")
    _close([float(m.aux.detach()) for m in moe], [float(a) for a in aux], tol, "per-block aux")
    _close(float(got_loss), float(want_loss), tol, "loss with aux")


def test_three_step_f64_lockstep(carried, x64):
    """Three train steps (ViT: SGD Nesterov; GPT: AdamW, the YAMLs'
    optimizers) through the JAX package's ``make_train_step`` and the
    port's ``train_step``: the losses (CE plus λ · the mean aux) agree."""
    arch, variables = carried
    yaml = "config/gpt_nano_moe.yaml" if arch == "gpt" else "config/vit_tiny_moe.yaml"
    jcfg.defrost()
    jcfg.merge_from_file(yaml)
    tconfig.merge_from_file(yaml)
    for c in (jcfg, tcfg):
        c.OPTIM.BASE_LR = 0.01 if arch == "vit" else 1e-3
    jm = _jax_model(arch, jnp.float64)
    params = _cast(variables, np.float64)
    model = _port(arch, variables, torch.float64).train()
    try:
        jopt = jax_construct_optimizer()
        state = TrainState(params=params, batch_stats={}, opt_state=jopt.init(params),
                           step=jnp.int32(0), key=jax.random.key(0))
        step = make_train_step(jm, jopt, topk=5)
        opt = construct_optimizer(model)
        jl, tl = [], []
        for i in range(3):
            b = _batch(arch, i)
            if arch == "vit":
                b["image"] = b["image"].astype(np.float64)
            if i == 0:
                _routing_agrees(arch, jm, params, model, jnp.asarray(b["image"]))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            jl.append(float(m["loss"]))
            tl.append(float(trainer.train_step(
                model, opt, {k: torch.from_numpy(v) for k, v in b.items()}, 5)["loss"]))
    finally:
        from distribuuuu_tpu import config as jconfig

        jconfig.reset_cfg()
    np.testing.assert_allclose(tl, jl, rtol=F64)
    assert tl[2] != tl[0]


@pytest.mark.parametrize("arch,jax_arch", [("vit", "vit_tiny_moe"), ("gpt", "gpt_nano_moe")])
def test_parameter_counts_at_full_width(arch, jax_arch):
    """ViT-Ti/16-MoE (1000 classes, 224²) and GPT-nano-MoE (vocab 320, 256
    positions): the same number of parameters as JAX's, counted on the
    meta device."""
    if arch == "gpt":
        jm = jmodels.build_model(jax_arch, num_classes=VOCAB, seq_len=256)
        dummy = jnp.zeros((2, 8), jnp.int32)
    else:
        jm = jmodels.build_model(jax_arch, num_classes=1000)
        dummy = jnp.zeros((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, dummy, train=False), jax.random.key(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = (GPT(vocab_size=VOCAB, seq_len=256, dim=128, depth=4, num_heads=4, moe_experts=8)
                 if arch == "gpt" else
                 ViT(num_classes=1000, dim=192, depth=12, num_heads=3, moe_experts=8))
    assert sum(p.numel() for p in model.parameters()) == want


def test_moe_decoder_greedy_tokens_equal_jax():
    """The MoE GPT's greedy streams through the port's engine (the decode
    step's MoE blocks on the dense reference path) equal the JAX engine's,
    at f32."""
    _, variables = _carry("gpt")
    engine = dict(prompt_len=8, max_new_tokens=6, batch_tiles=[1, 2], cache_tiles=[16],
                  eos_id=-1)
    prompts = [[5, 9, 2], [7, 1, 3, 4, 8, 2, 6, 0], [200]]
    jm = _jax_model("gpt", jnp.float32)
    jeng = jgen.GenerateEngine(jm, {"params": variables}, **engine).start()
    try:
        want = [s.result(timeout=120) for s in [jeng.submit(p) for p in prompts]]
    finally:
        jeng.drain()
    teng = tgen.GenerateEngine(_port("gpt", variables, torch.float32).eval(), device=CPU,
                               **engine).start()
    try:
        got = [s.result(timeout=120) for s in [teng.submit(p) for p in prompts]]
    finally:
        teng.drain()
    assert got == want and all(len(t) == 6 for t in got)


def test_train_net_runs_the_shipped_vit_tiny_moe_yaml(tmp_path, monkeypatch):
    """``train_net --cfg config/vit_tiny_moe.yaml`` at full width (toy
    input: 32², 10 classes, 8 dummy samples) builds and trains on the CPU,
    the balancing aux in its loss, and ``test_net`` evaluates its save."""
    from distribuuuu_tpu_torch import test_net, train_net
    from distribuuuu_tpu_torch.data import loader as tloader
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    monkeypatch.setattr(tloader, "_build_dataset",
                        lambda train: DummyDataset(8, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    args = ["--cfg", "config/vit_tiny_moe.yaml", "MODEL.DUMMY_INPUT", "True",
            "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
            "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "32",
            "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8", "OPTIM.MAX_EPOCH", "1",
            "RNG_SEED", "0", "OUT_DIR", str(tmp_path)]
    records = []
    monkeypatch.setattr(trainer, "train_model",
                        lambda _orig=trainer.train_model: _orig(records))
    assert train_net.main(args) == 100.0  # every dummy label is 0
    assert len(records[0]["losses"]) == 2
    reset_port_cfg()
    top1, _ = test_net.main(args + ["MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    assert top1 == 100.0
