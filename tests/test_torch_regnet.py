"""The port's RegNets (distribuuuu_tpu_torch/models/regnet.py) against the
JAX RegNets on the same weights, on the CPU at toy size.

* Parameter counts of the three archs against the published oracles
  (54.279M, 83.590M, 145.047M), built on the meta device; every leaf of
  each full-width JAX tree maps to exactly one port tensor of its shape.
* A toy RegNet (widths 16/24/32/56, group width 8, 32² input: two
  stride-1 grouped sites at 4² and 2²), X and Y: eval logits under
  ``DISTRIBUUUU_GROUP_CONV`` ``auto`` and ``pallas`` (the JAX side runs
  the Pallas kernel in interpret mode) within 1e-5 of the logit scale in
  f32; zeroing the grouped weights of the stride-1 sites moves the logits,
  so the kernel's output reaches them. ``random_variables`` gives every BN
  scale, the zero-initialised last BN of each block included, a seeded
  non-zero value.
* One f32 train step (ghost BN groups of 4) under ``auto`` and ``pallas``:
  the loss to 1e-5, every parameter, running stat and SGD trace to 2e-4
  of its tensor's largest magnitude (XLA and oneDNN sum in other orders).
* The SE gate alone against flax's; ``train_net`` and ``serve_net`` with
  config/regnety_160.yaml on a toy RegNet at ``DEVICE.PLATFORM cpu``.
"""

from __future__ import annotations

import signal

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    TOY_REGNET,
    few_threads,
    jax_regnet,
    port_regnet,
    random_variables,
    reset_port_cfg,
)

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.models import layers as tlayers
from distribuuuu_tpu_torch.models import regnet as tregnet
from distribuuuu_tpu_torch.ops.cuda import group_conv as gc
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import (
    jax_path_map,
    opt_state_from_jax,
    state_dict_from_jax,
)

IM, CLASSES, BATCH, GROUP = 32, 10, 8, 4
ORACLES = {"regnetx_160": 54.279, "regnety_160": 83.590, "regnety_320": 145.047}


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


@pytest.mark.parametrize("arch", list(ORACLES))
def test_param_count_matches_the_published_oracle(arch):
    model = tmodels.build_model(arch, num_classes=1000, device="meta")
    assert next(model.parameters()).device.type == "meta"
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - ORACLES[arch]) < 0.01


@pytest.mark.parametrize("arch", list(ORACLES))
def test_state_dict_from_jax_maps_every_leaf_once(arch):
    jmodel = jmodels.build_model(arch, num_classes=1000, dtype=jnp.float32)
    shapes = nn.unbox(jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.key(0)))
    paths = jax_path_map(shapes["params"])
    leaves = [*jax.tree_util.tree_leaves_with_path(shapes["params"]),
              *jax.tree_util.tree_leaves_with_path(shapes["batch_stats"])]
    assert len(paths) == len(set(paths.values())) == len(leaves)
    sd = tmodels.build_model(arch, num_classes=1000, device="meta").state_dict()
    assert set(sd) - set(paths.values()) == {k for k in sd if k.endswith("num_batches_tracked")}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = paths[tuple(p.key for p in path)]
            s = tuple(leaf.shape)
            want = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1] if len(s) == 2 else s
            assert tuple(sd[key].shape) == want, key


def _stride1_grouped(model):
    """The conv2 weights of the blocks that are not a stage's first."""
    return [blk.conv2.conv.weight for stage in model.stages for i, blk in enumerate(stage)
            if i > 0]


@pytest.mark.parametrize("se", [0.0, 0.25], ids=["x", "y"])
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_eval_logits_match_jax(monkeypatch, mode, se):
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", mode)
    calls = []
    real = gc.group_conv3x3_plain
    monkeypatch.setattr(gc, "group_conv3x3_plain",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    jmodel, shapes = jax_regnet(se)
    v = random_variables(shapes, seed=1)
    x = np.random.default_rng(2).standard_normal((2, IM, IM, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x))
    port = port_regnet(jmodel, v)
    assert (port.s2.b1.se is not None) is bool(se)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert calls == ([(2, 4, 4, 24), (2, 2, 2, 32)] if mode == "pallas" else [])
    with torch.no_grad():
        for w in _stride1_grouped(port):
            w.zero_()
    with torch.inference_mode():
        zeroed = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(zeroed - got).max() > 1e-3 * np.abs(got).max()


def _batch(step: int):
    rng = np.random.default_rng(30_000 + step)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return {"image": images, "label": labels, "mask": np.ones((BATCH,), np.float32)}


def _leaf(tree, path):
    for p in path:
        tree = tree.get(p) if isinstance(tree, dict) else None
        if tree is None:
            return None
    return np.asarray(tree)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_f32_train_step_matches_jax(monkeypatch, mode):
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", mode)
    jcfg.defrost()
    jcfg.OPTIM.BASE_LR = tcfg.OPTIM.BASE_LR = 0.05
    jmodel, shapes = jax_regnet(0.25, bn_group=GROUP)
    v = random_variables(shapes, seed=3)
    opt = jax_construct_optimizer()
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=opt.init(v["params"]), step=jnp.int32(0),
                       key=jax.random.key(0))
    state, m = jtrainer.make_train_step(jmodel, opt, topk=5)(state, _batch(0))
    model = port_regnet(jmodel, v, bn_group=GROUP).train()
    topt = construct_optimizer(model)
    b = _batch(0)
    loss = trainer.train_step(model, topt, {"image": torch.from_numpy(b["image"]),
                                            "label": torch.from_numpy(b["label"])}, 5)["loss"]
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5)
    sd, n = model.state_dict(), 0
    for path, key in jax_path_map(state.params).items():
        a = _leaf(state.params, path)
        if a is None:
            a = _leaf(state.batch_stats, path)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a
        np.testing.assert_allclose(sd[key].numpy(), a, rtol=2e-4,
                                   atol=2e-4 * np.abs(a).max(), err_msg=key)
        n += 1
    assert n == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    jstate = opt_state_from_jax(state.opt_state, state.params)
    for name, mom in zip(topt.names, topt.m):
        want = jstate["m"][name]
        np.testing.assert_allclose(mom.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)


def test_squeeze_excite_matches_flax():
    from distribuuuu_tpu.models.layers import SqueezeExcite as JaxSE

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 5, 24)).astype(np.float32)
    jse = JaxSE(6, dtype=jnp.float32)
    params = jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                          jax.eval_shape(jse.init, jax.random.key(0), x))["params"]
    want = np.asarray(jse.apply({"params": params}, x))
    se = tlayers.SqueezeExcite(24, 6, torch.float32)
    with torch.no_grad():
        for i, fc in enumerate((se.fc1, se.fc2)):
            fc.weight.copy_(torch.from_numpy(params[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)))
            fc.bias.copy_(torch.from_numpy(params[f"Conv_{i}"]["bias"]))
    for mode in (True, False):  # training: cast per call; eval: the cache
        got = se.train(mode)(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_is_seeded_and_the_last_bn_is_zero():
    a, b = (tregnet.regnety_160(num_classes=10, generator=torch.Generator().manual_seed(3))
            .state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not a["s3.b4.conv3.bn.weight"].any() and a["s3.b4.conv2.bn.weight"].eq(1).all()
    assert not a["s3.b4.se.fc1.bias"].any()
    fc1 = a["s3.b4.se.fc1.weight"]  # lecun normal: std sqrt(1 / fan_in)
    assert abs(float(fc1.std()) * fc1.shape[1] ** 0.5 - 1.0) < 0.05


def _toy(num_classes=1000, **kw):
    return tregnet._regnet(num_classes, **TOY_REGNET, se_ratio=0.25, **kw)


def test_train_net_and_serve_net_on_cpu_with_a_toy_regnet(tmp_path, monkeypatch):
    """config/regnety_160.yaml through the two CLIs, its arch swapped for
    the toy widths, under ``pallas``: the grouped sites take the kernel's
    entry point (its plain version on the CPU) in training, eval and
    serving."""
    from distribuuuu_tpu_torch import serve_net, train_net
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "pallas")
    monkeypatch.setitem(tmodels._REGISTRY, "regnety_160", _toy)
    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        16, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    calls = []
    real = gc.group_conv3x3_plain
    # calls on meta tensors are the telemetry ledger counting a step, not a step
    monkeypatch.setattr(gc, "group_conv3x3_plain",
                        lambda x, *a: (x.device.type != "meta" and calls.append(tuple(x.shape)))
                        or real(x, *a))
    common = ["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
              "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", str(IM), "RNG_SEED", "0",
              "OUT_DIR", str(tmp_path)]
    best = train_net.main(["--cfg", "config/regnety_160.yaml", *common, "MODEL.DUMMY_INPUT",
                           "True", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
                           "OPTIM.MAX_EPOCH", "1"])
    assert 0.0 <= best <= 100.0
    # 4 steps: 2 sites forward + 2 dx; eval: 2 batches x 2 sites
    assert len(calls) == 4 * 4 + 2 * 2
    reset_port_cfg()
    calls.clear()
    images = np.random.default_rng(0).integers(0, 256, (3, IM, IM, 3), np.uint8)
    np.save(tmp_path / "in.npy", images)
    serve_net.main(["--cfg", "config/regnety_160.yaml", "--batch-input",
                    str(tmp_path / "in.npy"), "--batch-output", str(tmp_path / "out.npy"),
                    *common, "SERVE.MAX_BATCH", "2", "SERVE.BUCKET_SIZES", "[1, 2]",
                    "MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (3, 10) and np.isfinite(out).all()
    assert len(calls) % 2 == 0 and len(calls) >= 2 * 2  # 2 sites a forward
    assert gc.group_conv3x3.launches == gc.group_conv3x3.launches_dx == 0
