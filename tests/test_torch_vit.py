"""The port's ViT (distribuuuu_tpu_torch/models/vit.py) and its training
slice against the JAX package, on the CPU at toy size.

* The weights: ``state_dict_from_jax`` maps every leaf of the JAX
  ViT-S/16 (1000 classes, 224²: 151 leaves, 22,049,896 parameters) onto
  one port tensor of the right shape.
* The forward: ViT-S widths (dim 384, 6 heads) at depth 2, 64² input
  (16 tokens), patch 16, 10 classes, f32, same numpy weights: logits
  agree to 1e-5 absolute (O(1) logits) under the dense, flash and
  blockwise attention. On the CPU the JAX flash path runs its blockwise
  scan (``flash_attention``'s off-TPU fallback) and the port's runs the
  kernels' plain versions.
* Three f32 train steps (SGD Nesterov, batch 4) in lockstep with the JAX
  train step under ``flash``: the losses agree to 1e-5 relative, and every
  parameter and SGD trace (mapped by ``opt_state_from_jax``) to 1e-4 of
  its tensor's largest magnitude. f32, not f64: both
  frameworks run attention in f32 whatever the input dtype, so no f64
  lockstep exists through it; the remaining differences are f32 sums in
  different orders, carried by three SGD steps into the weights.
* ``train_net``/``test_net`` with config/vit_tiny.yaml at toy size; the
  length-based ``auto`` routing; the refusals.
"""

from __future__ import annotations

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, jax_vit, random_variables, reset_port_cfg

from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.models import vit as tvit
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import (
    jax_path_map,
    opt_state_from_jax,
    state_dict_from_jax,
)

SMALL = dict(depth=2)  # ViT-S widths, depth cut to 2
IM, CLASSES, BATCH, STEPS = 64, 10, 4, 3


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


def _port_vit(variables, impl="xla", dtype=torch.float32):
    model = tmodels.build_model("vit_small", num_classes=CLASSES, dtype=dtype, img_size=IM,
                                attn_impl=impl, **SMALL)
    model.load_state_dict(state_dict_from_jax(variables["params"]))
    return model


def test_state_dict_from_jax_maps_every_vit_small_leaf_once():
    _, shapes = jax_vit("vit_small", num_classes=1000, im=224)
    leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    assert len(leaves) == 151
    assert sum(int(np.prod(leaf.shape)) for _, leaf in leaves) == 22_049_896
    paths = jax_path_map(shapes["params"])
    assert len(paths) == len(set(paths.values())) == 151
    with torch.device("meta"):
        port = tvit.ViT(num_classes=1000, dim=384, depth=12, num_heads=6)
    sd = port.state_dict()
    assert set(sd) == set(paths.values())
    assert sum(t.numel() for t in sd.values()) == 22_049_896
    for path, key in paths.items():
        node = shapes["params"]
        for p in path:
            node = node[p]
        s = tuple(node.shape)
        want = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s[::-1] if len(s) == 2 else s
        assert tuple(sd[key].shape) == want, key
    small = random_variables(jax_vit("vit_small", num_classes=CLASSES, im=IM, **SMALL)[1])
    _port_vit(small)  # loads strictly: every port tensor is filled
    with pytest.raises(KeyError, match="no port tensor"):
        state_dict_from_jax({**small["params"], "Extra_0": {"kernel": np.zeros((2, 2))}})


@pytest.mark.parametrize("impl", ["xla", "flash", "blockwise"])
def test_logits_match_jax(impl):
    model, shapes = jax_vit("vit_small", num_classes=CLASSES, im=IM, attn_impl=impl, **SMALL)
    v = random_variables(shapes, seed=1)
    x = np.random.default_rng(0).standard_normal((3, IM, IM, 3)).astype(np.float32)
    want = np.asarray(model.apply({"params": v["params"]}, jnp.asarray(x), train=False))
    port = _port_vit(v, impl).eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, CLASSES) and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5)


def _batch(step: int):
    rng = np.random.default_rng(20_000 + step)
    images = rng.standard_normal((BATCH, IM, IM, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return {"image": images, "label": labels, "mask": np.ones((BATCH,), np.float32)}


def test_f32_three_train_steps_lockstep_with_jax():
    jcfg.defrost()
    jcfg.OPTIM.BASE_LR = tcfg.OPTIM.BASE_LR = 0.05
    jmodel, shapes = jax_vit("vit_small", num_classes=CLASSES, im=IM, attn_impl="flash",
                             **SMALL)
    v = random_variables(shapes, seed=2)
    opt = jax_construct_optimizer()
    state = TrainState(params=v["params"], batch_stats={}, opt_state=opt.init(v["params"]),
                       step=jnp.int32(0), key=jax.random.key(0))
    step = jtrainer.make_train_step(jmodel, opt, topk=5)
    model = _port_vit(v, "flash").train()
    topt = construct_optimizer(model)
    jl, tl = [], []
    for i in range(STEPS):
        b = _batch(i)
        state, m = step(state, b)
        jl.append(float(m["loss"]))
        tb = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"])}
        tl.append(float(trainer.train_step(model, topt, tb, 5)["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] != tl[0]
    sd = model.state_dict()
    n = 0
    for path, key in jax_path_map(state.params).items():
        node = state.params
        for p in path:
            node = node[p]
        a = np.asarray(node)
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a
        np.testing.assert_allclose(sd[key].numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=key)
        n += 1
    assert n == len(sd) == 2 * 12 + 7
    # the SGD trace, carried over by opt_state_from_jax, agrees as well
    jstate = opt_state_from_jax(state.opt_state, state.params)
    assert jstate["count"] == topt.count == STEPS and jstate["v"] is None
    for name, m in zip(topt.names, topt.m):
        want = jstate["m"][name]
        np.testing.assert_allclose(m.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_auto_routes_to_flash_at_1024_tokens(monkeypatch):
    """ViT-Ti widths at 512² (1024 tokens) route every block's attention to
    the flash path under ``auto``; 496² (961 tokens) stays dense."""
    calls = []
    real = tvit.fa.flash_attention
    monkeypatch.setattr(tvit.fa, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    for im, n_flash in ((512, 2), (496, 0)):
        calls.clear()
        model = tmodels.build_model("vit_tiny", num_classes=CLASSES, dtype=torch.float32,
                                    img_size=im, attn_impl="auto", depth=2).eval()
        with torch.inference_mode():
            out = model(torch.zeros(1, im, im, 3))
        assert torch.isfinite(out).all()
        assert len(calls) == n_flash and all(s == (1, 3, 1024, 64) for s in calls)


def test_eval_after_a_step_sees_the_new_weights():
    _, shapes = jax_vit("vit_small", num_classes=CLASSES, im=IM, **SMALL)
    model = _port_vit(random_variables(shapes, seed=3), "flash")
    b = _batch(0)
    x = torch.from_numpy(b["image"][:2])
    with torch.inference_mode():
        before = model.eval().prepare()(x)
    trainer.train_step(model.train(), construct_optimizer(model),
                       {"image": torch.from_numpy(b["image"]),
                        "label": torch.from_numpy(b["label"])}, 5)
    with torch.inference_mode():
        after = model.eval()(x)
    fresh = tmodels.build_model("vit_small", num_classes=CLASSES, dtype=torch.float32,
                                img_size=IM, attn_impl="flash", **SMALL)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = fresh.eval()(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


def test_train_net_and_test_net_on_cpu_with_vit_tiny(tmp_path, monkeypatch):
    from distribuuuu_tpu_torch import test_net, train_net
    from distribuuuu_tpu_torch.data.dummy import DummyDataset
    from distribuuuu_tpu_torch.ops.cuda import flash_attention as tfa
    from distribuuuu_tpu_torch.ops.cuda import opt_update

    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        16, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    args = ["--cfg", "config/vit_tiny.yaml", "MODEL.DUMMY_INPUT", "True",
            "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
            "DEVICE.ATTN_IMPL", "flash", "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32",
            "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "64", "OPTIM.MAX_EPOCH", "1",
            "RNG_SEED", "0", "OUT_DIR", str(tmp_path)]
    best = train_net.main(args)
    assert 0.0 <= best <= 100.0
    assert (tmp_path / "checkpoints" / "best.pth").exists()
    reset_port_cfg()
    top1, _ = test_net.main(args + ["MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    assert top1 == best
    assert opt_update.update.launches == 0  # CPU tensors: no kernel
    assert tfa.launch_counts() == {"forward": 0, "dq": 0, "dkdv": 0}


def test_engine_serves_vit_as_its_direct_forward():
    """serve_net's engine on the CPU with config/vit_tiny.yaml and
    DEVICE.ATTN_IMPL flash: the served logits equal the model's own eval
    forward, row for row, whatever bucket a request lands in."""
    from distribuuuu_tpu_torch import config as tconfig
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    tconfig.merge_from_file("config/vit_tiny.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "DEVICE.ATTN_IMPL", "flash", "MODEL.NUM_CLASSES", CLASSES,
                          "TRAIN.IM_SIZE", 32, "SERVE.MAX_BATCH", 4,
                          "SERVE.BUCKET_SIZES", [2, 4], "RNG_SEED", 0])
    engine = engine_from_cfg().start()
    images = np.random.default_rng(0).integers(0, 256, (5, 32, 32, 3), np.uint8)
    got = np.stack([f.result(timeout=60) for f in [engine.submit(i) for i in images]])
    engine.drain()
    with torch.inference_mode():
        want = engine.model(normalize_on_device(torch.from_numpy(images))).numpy()
    assert engine.n_compiles == 2 and engine.model.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_refusals(tmp_path):
    tcfg.merge_from_list(["MODEL.ARCH", "vit_small", "DEVICE.ATTN_IMPL", "ring"])
    with pytest.raises(ValueError, match="needs a sequence-sharded mesh"):
        trainer.build_model_from_cfg()
    tcfg.DEVICE.ATTN_IMPL = "dense"
    with pytest.raises(ValueError, match="ViT archs accept"):
        trainer.build_model_from_cfg()
    tcfg.DEVICE.ATTN_IMPL = "flash"
    tcfg.MESH.SEQ = 2
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        trainer.build_model_from_cfg()
    tcfg.MESH.SEQ = 1
    tcfg.TRAIN.REMAT = True
    with pytest.raises(ValueError, match="TRAIN.REMAT"):
        trainer.build_model_from_cfg()
    assert len(tmodels.build_model("vit_tiny_moe", img_size=32).moe_layers()) == 6
    with pytest.raises(NotImplementedError, match="pipelined"):
        tmodels.build_model("vit_tiny", pipe_stages=2)
    with pytest.raises(ValueError, match="dropout"):
        tmodels.build_model("vit_tiny", dropout=0.1)
