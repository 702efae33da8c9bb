"""The port's EfficientNet-B0 (distribuuuu_tpu_torch/models/efficientnet.py)
against the JAX EfficientNet on the same weights, on the CPU, and the
port's dropout (``layers.Dropout``).

* The parameter count at full width (meta device) against the published
  5.289M; every leaf of the full-width JAX tree maps to exactly one port
  tensor of its shape (timm's names).
* efficientnet_b0 at full width and 32²: f32 eval logits within 1e-5 of
  the logit scale; the 32 expand/project/head ConvBNs take the
  conv-epilogue entry point (its plain version on the CPU), silu and id.
* One f32 train step (ghost BN groups of 4) of a narrow EfficientNet
  (widths 8/16/24, both kernel sizes, a residual block) against
  ``jtrainer.make_train_step``, dropout 0 on both sides (JAX's threefry
  mask cannot be drawn by a torch Generator): the loss to 1e-5, every
  parameter, running stat (momentum 0.99, eps 1e-3) and SGD trace to
  2e-4 of its tensor's largest magnitude. The bias of each block's
  project BN has no gradient (the shift it adds reaches only 1x1 convs
  whose batch-stat BNs subtract it again), so its trace is the weight
  decay plus rounding noise; those traces are held to 2e-4 of the whole
  trace's largest magnitude.
* Under ``DISTRIBUUUU_GROUP_CONV=pallas`` the depthwise convs never reach
  the grouped-conv entry point, in eval or in a train step.
* The dropout mask is a function of (seed, step, micro-batch, global row)
  only: two gloo ranks draw the rows one process draws; eval is the
  identity; ``train_step`` keys each micro-batch.
* ``train_net`` and ``serve_net`` with config/efficientnet_b0.yaml at 32².
"""

from __future__ import annotations

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ddp import finish, launch
from torch_port_util import (
    compare_with_jax,
    few_threads,
    jax_model,
    load_jax,
    random_variables,
    reset_port_cfg,
    train_steps_side_by_side,
)

from distribuuuu_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.models import layers as tlayers
from distribuuuu_tpu_torch.models.efficientnet import EfficientNet, efficientnet_b0
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
from distribuuuu_tpu_torch.ops.cuda import group_conv as gc
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import jax_path_map, opt_state_from_jax

IM, CLASSES, BATCH, GROUP = 32, 10, 8, 4
TOY = dict(blocks=((1, 8, 1, 1, 3), (6, 16, 2, 2, 5), (6, 24, 1, 2, 3)), stem_ch=8,
           head_ch=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")


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


def test_param_count_matches_the_published_oracle():
    model = tmodels.build_model("efficientnet_b0", num_classes=1000, device="meta")
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - 5.289) < 0.001


def test_state_dict_from_jax_maps_every_leaf_once():
    _, shapes = jax_model(JaxEfficientNet(num_classes=1000, dtype=jnp.float32))
    paths = jax_path_map(shapes["params"])
    leaves = [*jax.tree_util.tree_leaves_with_path(shapes["params"]),
              *jax.tree_util.tree_leaves_with_path(shapes["batch_stats"])]
    assert len(paths) == len(set(paths.values())) == len(leaves)
    sd = tmodels.build_model("efficientnet_b0", num_classes=1000, device="meta").state_dict()
    assert set(sd) - set(paths.values()) == {k for k in sd if k.endswith("num_batches_tracked")}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = paths[tuple(p.key for p in path)]
            s = tuple(leaf.shape)
            want = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1] if len(s) == 2 else s
            assert tuple(sd[key].shape) == want, key
    # timm's names: block 0 has no expand, the last stage one block
    assert sd["blocks.0.0.conv_pw.weight"].shape == (16, 32, 1, 1)
    assert sd["blocks.6.0.conv_pwl.weight"].shape == (320, 1152, 1, 1)
    assert sd["blocks.5.3.se.conv_reduce.weight"].shape == (48, 1152, 1, 1)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_eval_logits_match_jax(monkeypatch, mode):
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", mode)
    calls, grouped = [], []
    real, real_gc = ce.conv1x1_bn_act_plain, gc.group_conv3x3_plain
    monkeypatch.setattr(ce, "conv1x1_bn_act_plain",
                        lambda x, w, a, c, act, *r: calls.append(act) or real(x, w, a, c, act, *r))
    monkeypatch.setattr(gc, "group_conv3x3_plain",
                        lambda *a: grouped.append(1) or real_gc(*a))
    jmodel, shapes = jax_model(JaxEfficientNet(num_classes=CLASSES, dtype=jnp.float32))
    v = random_variables(shapes, seed=1)
    x = np.random.default_rng(2).standard_normal((2, IM, IM, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x))
    port = load_jax(efficientnet_b0(CLASSES, dtype=torch.float32), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert len(calls) == 32 and calls.count("silu") == 16 and not grouped  # 15 expands + head


def _batch(step: int):
    rng = np.random.default_rng(30_000 + step)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return {"image": images, "label": labels, "mask": np.ones((BATCH,), np.float32)}


def test_f32_train_step_matches_jax(monkeypatch):
    """Dropout 0 on both sides: the masks are drawn by different RNGs."""
    monkeypatch.setenv("DISTRIBUUUU_GROUP_CONV", "pallas")
    grouped = []
    real_gc = gc.group_conv3x3_plain
    monkeypatch.setattr(gc, "group_conv3x3_plain", lambda *a: grouped.append(1) or real_gc(*a))
    jmodel, shapes = jax_model(JaxEfficientNet(num_classes=CLASSES, dropout_rate=0.0,
                                               dtype=jnp.float32, bn_group=GROUP, **TOY))
    v = random_variables(shapes, seed=3)
    model = tlayers.build_on(EfficientNet, num_classes=CLASSES, dropout_rate=0.0,
                             dtype=torch.float32, bn_group=GROUP, **TOY)
    jloss, state, loss, model, topt = train_steps_side_by_side(jmodel, v, model, _batch(0))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    sd = model.state_dict()
    n = compare_with_jax((state.params, state.batch_stats), sd, 2e-4)
    assert n == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    jstate = opt_state_from_jax(state.opt_state, state.params)
    trace_scale = max(np.abs(m).max() for m in jstate["m"].values())
    for name, mom in zip(topt.names, topt.m):
        want = jstate["m"][name]
        no_grad = name.endswith(("bn3.bias", "0.0.bn2.bias"))  # the project BNs' biases
        scale = trace_scale if no_grad else np.abs(want).max()
        np.testing.assert_allclose(mom.numpy(), want, rtol=2e-4, atol=2e-4 * scale,
                                   err_msg=name)
    assert not grouped and gc.group_conv3x3.launches == 0


def test_bn_momentum_and_eps_are_per_module(monkeypatch):
    model = efficientnet_b0(10, dtype=torch.float32, device="meta")
    bns = [m for m in model.modules() if isinstance(m, tlayers.BatchNorm)]
    assert len(bns) == 49 and all(b.momentum == 0.99 and b.eps == 1e-3 for b in bns)
    assert tlayers.BatchNorm(4).momentum == 0.9  # the other families keep flax's 0.9
    bn = tlayers.BatchNorm(3, momentum=0.99).train()
    x = torch.arange(24.0).reshape(8, 3)
    monkeypatch.setenv("DISTRIBUUUU_BN_MOMENTUM", "0.5")  # overrides every module's own
    bn(x, torch.float32)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.5 * x.mean(0).numpy())


def _keep(out: torch.Tensor, rate: float) -> torch.Tensor:
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1.0 / (1.0 - rate)))
    return kept


def test_dropout_mask_is_a_function_of_seed_step_micro_and_global_row(tmp_path):
    rate, shape, key = 0.2, (1280,), (0, 7, 1)
    layer = tlayers.Dropout(rate).train()
    one = _keep(layer(torch.ones(8, *shape), key), rate)
    assert abs(float(one.float().mean()) - (1 - rate)) < 0.02
    assert torch.equal(_keep(layer(torch.ones(8, *shape), key), rate), one)  # no hidden state
    for other in ((1, 7, 1), (0, 8, 1), (0, 7, 0)):
        assert not torch.equal(_keep(layer(torch.ones(8, *shape), other), rate), one)
    x = torch.randn(8, *shape)
    assert torch.equal(layer.eval()(x, key), x) and torch.equal(layer.eval()(x), x)
    with pytest.raises(ValueError, match="needs its key"):
        layer.train()(x)
    spec = {"out": str(tmp_path), "scenarios": [{"name": "dropout", "kind": "dropout",
                                                 "rate": rate, "shape": list(shape),
                                                 "global_batch": 8, "key": list(key)}]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    finish(launch(2, [WORKER, str(tmp_path / "spec.json")], str(tmp_path), "dropout"))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)["dropout"]["out"]
             for r in (0, 1)]
    assert torch.equal(_keep(torch.cat(ranks), rate), one)


def test_train_step_keys_each_micro_batch(monkeypatch):
    tcfg.RNG_SEED = 5
    model = tlayers.build_on(EfficientNet, num_classes=CLASSES, dtype=torch.float32, **TOY)
    keys = []
    real = tlayers.Dropout.forward
    monkeypatch.setattr(tlayers.Dropout, "forward",
                        lambda self, x, key=None: keys.append(key.key) or real(self, x, key))
    opt = construct_optimizer(model)
    b = _batch(0)
    batch = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"])}
    for _ in range(2):
        trainer.train_step(model.train(), opt, batch, 5, accum=2)
    assert keys == [(5, 0, 0), (5, 0, 1), (5, 1, 0), (5, 1, 1)]


def test_train_net_and_serve_net_on_cpu(tmp_path, monkeypatch):
    """config/efficientnet_b0.yaml through the two CLIs at full width and
    32²: dropout 0.2 in the train steps, 32 conv-epilogue sites an eval
    forward."""
    from distribuuuu_tpu_torch import serve_net, train_net
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        8, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    calls = []
    real = ce.conv1x1_bn_act_plain
    # calls on meta tensors are the telemetry ledger counting a step, not a step
    monkeypatch.setattr(ce, "conv1x1_bn_act_plain",
                        lambda *a, **k: (a[0].device.type != "meta" and calls.append(1))
                        or real(*a, **k))
    common = ["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
              "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", str(IM), "RNG_SEED", "0",
              "OUT_DIR", str(tmp_path)]
    best = train_net.main(["--cfg", "config/efficientnet_b0.yaml", *common,
                           "MODEL.DUMMY_INPUT", "True", "TRAIN.BATCH_SIZE", "4",
                           "TEST.BATCH_SIZE", "8", "OPTIM.MAX_EPOCH", "1"])
    assert 0.0 <= best <= 100.0
    assert len(calls) == 32  # one eval forward of 8 images
    reset_port_cfg()
    images = np.random.default_rng(0).integers(0, 256, (3, IM, IM, 3), np.uint8)
    np.save(tmp_path / "in.npy", images)
    serve_net.main(["--cfg", "config/efficientnet_b0.yaml", "--batch-input",
                    str(tmp_path / "in.npy"), "--batch-output", str(tmp_path / "out.npy"),
                    *common, "SERVE.MAX_BATCH", "2", "SERVE.BUCKET_SIZES", "[1, 2]",
                    "MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (3, 10) and np.isfinite(out).all()
