"""Gradient accumulation in the port's step (``trainer.train_step`` with
``accum``, ``TRAIN.GRAD_ACCUM_STEPS``) against the JAX package's
``accum_train_step``, on the CPU at toy size.

resnet18, 10 classes, 32², batch 8, ghost BN groups of 2, f64 state, as
tests/test_torch_train.py sets it up. One accumulated step at accum 2 and
4 (micro-batches of 4 and 2: the BN running stats carried from micro to
micro) of JAX's ``make_train_step(..., accum_steps=k)`` fed
``shard_micro_batch`` on one device, and of the port's ``train_step``:
every parameter, momentum trace and running stat within 1e-7 of its
tensor's largest magnitude, the mean loss and Acc@1 to 1e-7 relative.
Then the batch geometry's refusals, one all-reduce and one optimizer
update per step, ``skip`` restoring the stats from before the first
micro-batch, and ``train_model`` with ``GRAD_ACCUM_STEPS 2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_port_util import (
    compare_with_jax,
    few_threads,
    jax_resnet,
    jax_trace,
    random_variables,
    reset_port_cfg,
    stream_batch,
)

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel import sharding as jsharding
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

BATCH, GROUP, LR, TOL = 8, 2, 0.05, 1e-7


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


def port_model(weights, dtype=torch.float64, group=GROUP, **kw):
    model = tmodels.build_model("resnet18", num_classes=10, dtype=dtype, bn_group=group, **kw)
    model.load_state_dict(state_dict_from_jax(weights["params"], weights["batch_stats"]))
    return model.to(dtype).train()


def port_batch(b, dtype=torch.float64):
    return {"image": torch.from_numpy(b["image"]).to(dtype),
            "label": torch.from_numpy(b["label"])}


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_jax_at_f64(weights, accum):
    b = stream_batch(0, BATCH)
    jax.config.update("jax_enable_x64", True)
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        jcfg.OPTIM.BASE_LR = LR
        jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.float64,
                                     bn_group=GROUP)
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
        opt = jax_construct_optimizer()
        state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                           opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                           key=jax.random.key(0))
        step = jtrainer.make_train_step(jmodel, opt, topk=5, accum_steps=accum)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        state, m = step(state, jsharding.shard_micro_batch(mesh, b, accum))
        want = jax.tree.map(np.asarray, (state.params, state.batch_stats,
                                         jax_trace(state.opt_state)))
        want_loss, want_top1 = float(m["loss"]), float(m["top1"])
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)

    tcfg.OPTIM.BASE_LR = LR
    model = port_model(weights)
    opt = construct_optimizer(model)
    got = trainer.train_step(model, opt, port_batch(b), 5, accum=accum)
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=TOL)
    np.testing.assert_allclose(float(got["top1"]), want_top1, rtol=TOL)
    params, stats, trace = want
    assert compare_with_jax((params, stats), model.state_dict(), TOL) > 100
    assert compare_with_jax((trace,), dict(zip(opt.names, opt.m)), TOL) == len(opt.names)
    assert opt.count == 1


def test_accum_rejects_indivisible_batch():
    """The step refuses a batch that does not split into ``accum`` slices,
    and the geometry check refuses it before any work, naming the knob."""
    model = tmodels.build_model("resnet18", num_classes=10, dtype=torch.float32)
    batch = {"image": torch.zeros(16, 8, 8, 3), "label": torch.zeros(16, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible"):
        trainer.train_step(model.train(), construct_optimizer(model), batch, 5, accum=3)
    tcfg.merge_from_list(["TRAIN.BATCH_SIZE", 16, "TRAIN.GRAD_ACCUM_STEPS", 3])
    with pytest.raises(ValueError, match="GRAD_ACCUM_STEPS"):
        trainer.check_batch_geometry(1)


@pytest.mark.parametrize("batch,accum,group,world,error", [
    (8, 2, 4, 1, None),  # micro 4: one group each
    (8, 2, 8, 1, None),  # the group is past the micro-batch: one group
    (8, 2, 3, 2, ValueError),  # 3 does not divide the global micro-batch of 8
    (8, 4, 4, 2, None),  # micro 2 a rank: one group spans both ranks
    (8, 4, 3, 3, NotImplementedError),  # a group of 3 cuts the 2-image micro-batches
])
def test_ghost_group_is_checked_against_the_global_micro_batch(batch, accum, group, world,
                                                                error):
    tcfg.merge_from_list(["TRAIN.BATCH_SIZE", batch, "TRAIN.GRAD_ACCUM_STEPS", accum,
                          "MODEL.BN_GROUP", group])
    if error is None:
        trainer.check_batch_geometry(world)
    else:
        with pytest.raises(error, match="GRAD_ACCUM_STEPS|cuts a process's batch"):
            trainer.check_batch_geometry(world)


def test_one_all_reduce_and_one_update_per_step(weights, monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "all_reduce_grads", lambda grads: calls.append(len(grads)))
    model = port_model(weights, torch.float32)
    opt = construct_optimizer(model)
    for i in range(2):
        trainer.train_step(model, opt, port_batch(stream_batch(i), torch.float32), 5, accum=4)
    assert calls == [len(opt.params)] * 2 and opt.count == 2


def test_skip_restores_the_stats_from_before_the_first_micro_batch(weights):
    model = port_model(weights, torch.float32)
    opt = construct_optimizer(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = trainer.train_step(model, opt, port_batch(stream_batch(0), torch.float32), 5,
                           policy="skip", accum=2, poison=True)
    assert float(m["nonfinite"]) == 1.0 and opt.count == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_model_with_grad_accum(tmp_path, monkeypatch):
    from distribuuuu_tpu_torch.data import loader as tloader
    from distribuuuu_tpu_torch.data.dummy import DummyDataset
    from distribuuuu_tpu_torch.utils import checkpoint as ckpt

    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        16, tcfg.TRAIN.IM_SIZE, raw_u8=True))
    tcfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
        "TRAIN.IM_SIZE", 32, "TRAIN.BATCH_SIZE", 4, "TRAIN.GRAD_ACCUM_STEPS", 2,
        "TEST.BATCH_SIZE", 8, "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 1,
        "OPTIM.MAX_EPOCH", 1, "OUT_DIR", str(tmp_path)])
    best = trainer.train_model()
    assert best > 50.0  # every dummy label is 0
    payload = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    assert payload["step"] == payload["opt"]["count"] == 4  # 16 images, steps of 4
