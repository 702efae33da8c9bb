"""The port's DenseNets (distribuuuu_tpu_torch/models/densenet.py) against
the JAX DenseNets on the same weights, on the CPU.

* Parameter counts of the four archs at full width (meta device) against
  the published oracles; every leaf of each full-width JAX tree maps to
  exactly one port tensor of its shape (torchvision's names).
* A narrow DenseNet (growth 8, blocks 2/3/2/2, 16 stem channels, bn_size 2)
  at 32²: f32 eval logits within 1e-5 of the logit scale; zeroing the
  dense layers' 3x3 weights moves them; no conv-epilogue site (every conv
  but the 7x7 stem is pre-activation), and the concatenation stays
  channels last.
* One f32 train step of it (ghost BN groups of 4) against
  ``jtrainer.make_train_step``: the loss to 1e-5, every parameter,
  running stat and SGD trace to 2e-4 of its tensor's largest magnitude.
* ``memory_efficient`` against the plain layers at f64: loss, gradients
  and running stats bitwise equal (the counterpart of JAX's
  ``test_densenet_memory_efficient_grads_match``).
* ``TRAIN.REMAT`` refused for a DenseNet, and ``train_net`` and
  ``serve_net`` with config/resnet50.yaml and ``MODEL.ARCH densenet121``
  at full width and 32².
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

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu.models.densenet import DenseNet as JaxDenseNet
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.models import layers as tlayers
from distribuuuu_tpu_torch.models.densenet import DenseNet
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
from distribuuuu_tpu_torch.utils.weights import jax_path_map, opt_state_from_jax

IM, CLASSES, BATCH, GROUP = 32, 10, 8, 4
ORACLES = {"densenet121": 7.979, "densenet161": 28.681, "densenet169": 14.149,
           "densenet201": 20.014}
TOY = dict(growth_rate=8, block_config=(2, 3, 2, 2), num_init_features=16, bn_size=2)


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


def _toy(**kw):
    return tlayers.build_on(DenseNet, num_classes=CLASSES, **TOY, **kw)


@pytest.mark.parametrize("arch", list(ORACLES))
def test_param_count_matches_the_published_oracle(arch):
    model = tmodels.build_model(arch, num_classes=1000, device="meta")
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - ORACLES[arch]) < 0.001


@pytest.mark.parametrize("arch", list(ORACLES))
def test_state_dict_from_jax_maps_every_leaf_once(arch):
    _, shapes = jax_model(jmodels.build_model(arch, num_classes=1000, dtype=jnp.float32))
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
    assert "features.transition3.conv.weight" in sd and "features.norm5.weight" in sd


def test_eval_logits_match_jax(monkeypatch):
    calls = []
    real = ce.conv1x1_bn_act_plain
    monkeypatch.setattr(ce, "conv1x1_bn_act_plain", lambda *a, **k: calls.append(1) or real(*a))
    jmodel, shapes = jax_model(JaxDenseNet(num_classes=CLASSES, dtype=jnp.float32, **TOY))
    v = random_variables(shapes, seed=1)
    x = np.random.default_rng(2).standard_normal((2, IM, IM, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x))
    port = load_jax(_toy(dtype=torch.float32), v)
    seen = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda ts, dim: seen.append(cat(ts, dim)) or seen[-1])
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert not calls and sum(u.fused for u in port.conv_units()) == 0
    assert len(seen) == 9 and all(t.is_contiguous() for t in seen)  # NHWC: channels last
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, type(port.features.denseblock1.denselayer1)):
                m.conv2.weight.zero_()
    with torch.inference_mode():
        zeroed = port.train().eval()(torch.from_numpy(x)).numpy()
    assert np.abs(zeroed - got).max() > 1e-3 * np.abs(got).max()


def _batch(step: int, dtype=np.float32):
    rng = np.random.default_rng(30_000 + step)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(dtype)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return {"image": images, "label": labels, "mask": np.ones((BATCH,), dtype)}


def test_f32_train_step_matches_jax():
    jmodel, shapes = jax_model(JaxDenseNet(num_classes=CLASSES, dtype=jnp.float32,
                                           bn_group=GROUP, **TOY))
    v = random_variables(shapes, seed=3)
    jloss, state, loss, model, topt = train_steps_side_by_side(
        jmodel, v, _toy(dtype=torch.float32, bn_group=GROUP), _batch(0))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    sd = model.state_dict()
    n = compare_with_jax((state.params, state.batch_stats), sd, 2e-4)
    assert n == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    jstate = opt_state_from_jax(state.opt_state, state.params)
    for name, mom in zip(topt.names, topt.m):
        want = jstate["m"][name]
        np.testing.assert_allclose(mom.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)


def test_memory_efficient_is_bitwise_the_plain_layers_at_f64():
    b = _batch(1, np.float64)
    x = torch.from_numpy(b["image"])
    outs = []
    for mem in (False, True):
        model = _toy(dtype=torch.float64, bn_group=GROUP, memory_efficient=mem,
                     generator=torch.Generator().manual_seed(4)).double().train()
        loss = (model(x) ** 2).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        outs.append((loss, grads, [t.clone() for t in model.buffers()]))
    (l0, g0, s0), (l1, g1, s1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))  # the stats moved once
    assert not torch.equal(s0[1], torch.ones_like(s0[1]))


def test_remat_is_refused_for_densenet():
    tcfg.MODEL.ARCH = "densenet121"
    tcfg.TRAIN.REMAT = True
    with pytest.raises(ValueError, match="does not take the knob") as e:
        trainer.build_model_from_cfg()
    assert "always" not in str(e.value)


def test_train_net_and_serve_net_on_cpu(tmp_path, monkeypatch):
    """config/resnet50.yaml with MODEL.ARCH densenet121 through the two
    CLIs at full width and 32²."""
    from distribuuuu_tpu_torch import serve_net, train_net
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        8, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    common = ["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
              "MODEL.ARCH", "densenet121", "MODEL.NUM_CLASSES", "10",
              "TRAIN.IM_SIZE", str(IM), "RNG_SEED", "0", "OUT_DIR", str(tmp_path)]
    best = train_net.main(["--cfg", "config/resnet50.yaml", *common, "MODEL.DUMMY_INPUT",
                           "True", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8",
                           "OPTIM.MAX_EPOCH", "1"])
    assert 0.0 <= best <= 100.0
    reset_port_cfg()
    images = np.random.default_rng(0).integers(0, 256, (3, IM, IM, 3), np.uint8)
    np.save(tmp_path / "in.npy", images)
    serve_net.main(["--cfg", "config/resnet50.yaml", "--batch-input",
                    str(tmp_path / "in.npy"), "--batch-output", str(tmp_path / "out.npy"),
                    *common, "SERVE.MAX_BATCH", "2", "SERVE.BUCKET_SIZES", "[1, 2]",
                    "MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    out = np.load(tmp_path / "out.npy")
    assert out.shape == (3, 10) and np.isfinite(out).all()
