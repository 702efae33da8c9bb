"""The port's BoTNet-50 (distribuuuu_tpu_torch/models/botnet.py) against
the JAX BoTNet-50 on the same weights, on the CPU.

* The parameter count at full width (built on the meta device) against
  the published 20.859M; every leaf of the full-width JAX tree maps to
  exactly one port tensor of its shape.
* Full width at 32² input, so the attention grid is 2² (JAX's own test
  size): f32 eval logits within 1e-5 of the logit scale. ``random_variables``
  gives every BN scale, the zero-initialised last BN of each block
  included, a seeded non-zero value; zeroing the attention's value
  weights then moves the logits, so the MHSA reaches them. In eval the 34
  pointwise ConvBNs take the conv-epilogue entry point (its plain version
  on the CPU), the stack's ReLU shortcut among them.
* One train step (ghost BN groups of 4) against
  ``jtrainer.make_train_step``: the loss to 1e-5, every parameter,
  running stat and SGD trace to 2e-4 of its tensor's largest magnitude.
  The JAX BoTNet-50 has no width knob, and at full width an f32 train
  step is chaotic on both sides (a ResNet-50 trunk alone too: at 32² or
  64² some tensors' updates differ by 20 % between XLA and PyTorch, from
  rounding), so this step runs at f64 on both sides (jax x64), where
  the only rounding left is the fp32 softmax island both keep.
* The grid assertion and the ``attn_impl`` refusal, the fmap the trainer
  derives from ``TRAIN.IM_SIZE``, and ``train_net`` and ``serve_net`` with
  config/botnet50.yaml at 32² on ``DEVICE.PLATFORM cpu``.
"""

from __future__ import annotations

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    compare_with_jax,
    few_threads,
    jax_model,
    load_jax,
    random_variables,
    reset_port_cfg,
    train_steps_side_by_side,
)

from distribuuuu_tpu.models.botnet import botnet50 as jax_botnet50
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.models.botnet import MHSA2D, botnet50
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
from distribuuuu_tpu_torch.utils.weights import jax_path_map, opt_state_from_jax

IM, CLASSES, BATCH, GROUP, FMAP = 32, 10, 8, 4, (2, 2)


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


@pytest.fixture(scope="module")
def jax_net():
    jmodel, shapes = jax_model(jax_botnet50(CLASSES, FMAP, dtype=jnp.float32, bn_group=GROUP))
    return jmodel, random_variables(shapes, seed=1)


def test_param_count_matches_the_published_oracle():
    model = tmodels.build_model("botnet50", num_classes=1000, device="meta")
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - 20.859) < 0.001


def test_state_dict_from_jax_maps_every_leaf_once():
    _, shapes = jax_model(jax_botnet50(1000, dtype=jnp.float32), im=224)
    paths = jax_path_map(shapes["params"])
    leaves = [*jax.tree_util.tree_leaves_with_path(shapes["params"]),
              *jax.tree_util.tree_leaves_with_path(shapes["batch_stats"])]
    assert len(paths) == len(set(paths.values())) == len(leaves)
    sd = tmodels.build_model("botnet50", num_classes=1000, device="meta").state_dict()
    assert set(sd) - set(paths.values()) == {k for k in sd if k.endswith("num_batches_tracked")}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = paths[tuple(p.key for p in path)]
            s = tuple(leaf.shape)
            want = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
            if len(s) == 2 and not key.endswith(("rel_height", "rel_width")):
                want = s[::-1]
            assert tuple(sd[key].shape) == want, key
    assert sd["layer4.0.mhsa.rel_height"].shape == (27, 128)  # 2·14 − 1


def test_eval_logits_match_jax_and_the_mhsa_reaches_them(jax_net, monkeypatch):
    jmodel, v = jax_net
    x = np.random.default_rng(2).standard_normal((2, IM, IM, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x))
    calls = []
    real = ce.conv1x1_bn_act_plain
    monkeypatch.setattr(ce, "conv1x1_bn_act_plain",
                        lambda x, w, a, c, act, *r: calls.append(act) or real(x, w, a, c, act, *r))
    port = load_jax(botnet50(CLASSES, FMAP, dtype=torch.float32), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert len(calls) == 34 and calls.count("relu") == 17  # 16 conv1s + the shortcut
    with torch.no_grad():
        for blk in port.layer4:
            blk.mhsa.to_v.weight.zero_()
    with torch.inference_mode():
        zeroed = port.train().eval()(torch.from_numpy(x)).numpy()
    assert np.abs(zeroed - got).max() > 1e-3 * np.abs(got).max()


def _batch(step: int):
    rng = np.random.default_rng(30_000 + step)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return {"image": images, "label": labels, "mask": np.ones((BATCH,), np.float32)}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def test_f64_train_step_matches_jax(x64):
    jmodel, shapes = jax_model(jax_botnet50(CLASSES, FMAP, dtype=jnp.float64, bn_group=GROUP))
    v = jax.tree.map(lambda a: a.astype(np.float64), random_variables(shapes, seed=1))
    batch = {k: a.astype(np.float64) if a.dtype == np.float32 else a
             for k, a in _batch(0).items()}
    jloss, state, loss, model, topt = train_steps_side_by_side(
        jmodel, v, botnet50(CLASSES, FMAP, dtype=torch.float64, bn_group=GROUP).double(),
        batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    sd = model.state_dict()
    n = compare_with_jax((state.params, state.batch_stats), sd, 2e-4)
    assert n == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    jstate = opt_state_from_jax(state.opt_state, state.params)
    for name, mom in zip(topt.names, topt.m):
        want = jstate["m"][name]
        np.testing.assert_allclose(mom.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)


def test_grid_assertion_and_attn_impl_refusal():
    m = MHSA2D(16, (4, 4), heads=2, dim_qk=8, dim_v=8, dtype=torch.float32)
    m.to_qk.weight.data.normal_()
    m.to_v.weight.data.normal_()
    m.init_params(torch.Generator().manual_seed(0))
    assert m(torch.ones(2, 4, 4, 16)).shape == (2, 4, 4, 16)
    with pytest.raises(AssertionError, match="grid mismatch"):
        m(torch.ones(2, 5, 5, 16))
    with pytest.raises(ValueError, match="'auto'/'xla'"):
        MHSA2D(16, (4, 4), attn_impl="flash")


@pytest.mark.parametrize("im,fmap", [(224, 14), (32, 2), (40, 3)])
def test_trainer_derives_the_grid_from_the_train_size(im, fmap):
    tcfg.MODEL.ARCH = "botnet50"
    tcfg.TRAIN.IM_SIZE = im
    tcfg.MODEL.NUM_CLASSES = 10
    model = trainer.build_model_from_cfg()
    assert all(blk.mhsa.fmap_size == (fmap, fmap) for blk in model.layer4)
    tcfg.DEVICE.ATTN_IMPL = "flash"
    with pytest.raises(ValueError, match="'auto'/'xla'"):
        trainer.build_model_from_cfg()


def test_train_net_and_serve_net_on_cpu(tmp_path, monkeypatch):
    """config/botnet50.yaml through the two CLIs at full width and 32²
    (the grid 2²): 34 conv-epilogue sites an eval forward."""
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
    best = train_net.main(["--cfg", "config/botnet50.yaml", *common, "MODEL.DUMMY_INPUT",
                           "True", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
                           "OPTIM.MAX_EPOCH", "1"])
    assert 0.0 <= best <= 100.0
    assert len(calls) == 34  # one eval forward of 8 images
    reset_port_cfg()
    images = np.random.default_rng(0).integers(0, 256, (3, IM, IM, 3), np.uint8)
    np.save(tmp_path / "in.npy", images)
    serve_net.main(["--cfg", "config/botnet50.yaml", "--batch-input",
                    str(tmp_path / "in.npy"), "--batch-output", str(tmp_path / "out.npy"),
                    *common, "SERVE.MAX_BATCH", "2", "SERVE.BUCKET_SIZES", "[1, 2]",
                    "MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (3, 10) and np.isfinite(out).all()
