"""``TRAIN.REMAT`` in the port (models/resnet.py, the BatchNorm phases of
models/layers.remat_contexts): stages 1-2 of a ResNet recomputed in the
backward through ``torch.utils.checkpoint``, on the CPU at toy size.

* A remat step is bitwise the plain step of the port, at f64 and f32 (the
  same ops in the same order): loss, parameters, running stats, momentum.
* A remat step at f64 matches JAX's ``nn.remat`` step within 1e-7 of each
  tensor's largest magnitude (resnet18, 32², batch 8, ghost groups of 4).
* The running stats move once per forward: the recompute reuses the
  forward's shift and leaves them alone.
* With SyncBN in a one-process gloo group, each BatchNorm of stages 1-2
  all-reduces its sums once more per step (the recompute), on every
  process in the same order: resnet18 has 9 such BatchNorms, so a step's
  all-reduces go from 46 to 55 (20 forward + 20 backward + 5 buckets of
  f64 gradients + 1 for the metrics).
* The parameters and ``state_dict`` are the same with the knob on or off.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    compare_with_jax,
    few_threads,
    jax_resnet,
    random_variables,
    reset_port_cfg,
    stream_batch,
)

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.models.layers import BatchNorm
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

GROUP, LR, TOL = 4, 0.05, 1e-7


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


@pytest.fixture(scope="module")
def weights():
    _, shapes = jax_resnet("resnet18")
    return random_variables(shapes, seed=5)


def port_model(weights, dtype, remat, group=GROUP):
    model = tmodels.build_model("resnet18", num_classes=10, dtype=dtype, bn_group=group,
                                remat=remat)
    model.load_state_dict(state_dict_from_jax(weights["params"], weights["batch_stats"]))
    return model.to(dtype).train()


def port_steps(weights, dtype, remat, steps=2, group=GROUP):
    tcfg.OPTIM.BASE_LR = LR
    model = port_model(weights, dtype, remat, group)
    opt = construct_optimizer(model)
    losses = []
    for i in range(steps):
        b = stream_batch(i)
        m = trainer.train_step(model, opt, {"image": torch.from_numpy(b["image"]).to(dtype),
                                            "label": torch.from_numpy(b["label"])}, 5)
        losses.append(float(m["loss"]))
    return losses, model, opt


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_remat_step_is_bitwise_the_plain_step(weights, dtype):
    plain_l, plain, plain_opt = port_steps(weights, dtype, False)
    remat_l, remat, remat_opt = port_steps(weights, dtype, True)
    assert remat.remat and not plain.remat
    assert remat_l == plain_l and remat_l[1] != remat_l[0]
    for k, v in plain.state_dict().items():
        assert torch.equal(v, remat.state_dict()[k]), k
    for a, b in zip(plain_opt.m, remat_opt.m):
        assert torch.equal(a, b)


def test_remat_step_matches_jax_remat_at_f64(weights):
    b = stream_batch(0)
    jax.config.update("jax_enable_x64", True)
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        jcfg.OPTIM.BASE_LR = LR
        jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.float64,
                                     bn_group=GROUP, remat=True)
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
        opt = jax_construct_optimizer()
        state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                           opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                           key=jax.random.key(0))
        state, m = jtrainer.make_train_step(jmodel, opt, topk=5)(state, b)
        want = jax.tree.map(np.asarray, (state.params, state.batch_stats))
        want_loss = float(m["loss"])
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)
    losses, model, _ = port_steps(weights, torch.float64, True, steps=1)
    np.testing.assert_allclose(losses[0], want_loss, rtol=TOL)
    assert compare_with_jax(want, model.state_dict(), TOL) > 100


def test_running_stats_move_once_per_forward(weights):
    """One remat step's running stats equal one plain forward's update
    (a second update in the recompute would move them again)."""
    _, remat, _ = port_steps(weights, torch.float64, True, steps=1)
    model = port_model(weights, torch.float64, False)
    b = stream_batch(0)
    with torch.no_grad():
        model(torch.from_numpy(b["image"]))
    moved = 0
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            r = remat.get_submodule(name)
            assert torch.equal(m.running_mean, r.running_mean), name
            assert torch.equal(m.running_var, r.running_var), name
            moved += name.startswith(("layer1", "layer2"))
    assert moved == 9


def test_syncbn_all_reduces_once_more_per_stage12_bn_under_remat(weights, tmp_path,
                                                                 monkeypatch):
    real = torch.distributed.all_reduce
    calls = {"n": 0}

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         world_size=1, rank=0)
    try:
        monkeypatch.setattr(torch.distributed, "all_reduce", counted)
        counts = {}
        for remat in (False, True):
            calls["n"] = 0
            port_steps(weights, torch.float64, remat, steps=1, group=0)
            counts[remat] = calls["n"]
    finally:
        dist.shutdown_distributed()
    assert counts == {False: 46, True: 55}


def test_state_dict_interchanges_and_eval_skips_remat(weights):
    plain = port_model(weights, torch.float64, False)
    remat = port_model(weights, torch.float64, True)
    assert list(plain.state_dict()) == list(remat.state_dict())
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(stream_batch(0)["image"][:2])
    with torch.inference_mode():
        assert torch.equal(plain.eval()(x), remat.eval()(x))


def test_build_model_from_cfg_passes_remat_to_the_resnets_only():
    tcfg.merge_from_list(["MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10,
                          "TRAIN.REMAT", True])
    assert trainer.build_model_from_cfg().remat
    tcfg.MODEL.ARCH = "regnetx_160"
    with pytest.raises(ValueError, match="TRAIN.REMAT"):
        trainer.build_model_from_cfg()
