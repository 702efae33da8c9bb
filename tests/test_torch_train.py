"""The port's training slice (distribuuuu_tpu_torch/trainer.py and what it
runs) against the JAX trainer, on the CPU at toy size.

* The step in lockstep: resnet18, 10 classes, 32², batch 8, ghost BN
  groups of 4, f64 compute and f64 state (as tests/test_trajectory_x64.py
  sets it up). Three steps of the JAX ``make_train_step`` on one device
  and of the port's ``train_step``, from the same weights and batches:
  the losses agree to 1e-7 relative, and every parameter and running stat
  to 1e-7 of its tensor's largest magnitude.
* One f32 step agrees to 2e-4 of each tensor's largest magnitude: XLA and
  oneDNN sum the convs in different orders, which one step of SGD
  carries into the weights.
* The dummy loader is byte-identical to the JAX loaders; ``get_epoch_lr``
  equals the JAX schedule; resume is bit-identical to an uninterrupted
  run; eval after a step sees the new weights; the non-finite policies;
  the refusals of what this slice does not run.
"""

from __future__ import annotations

import os
import signal

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
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.ops.cuda import opt_update
from distribuuuu_tpu_torch.resilience.supervisor import NonFiniteLossError
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults
from distribuuuu_tpu_torch.utils import schedules as tsched
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import jax_path_map, state_dict_from_jax

BATCH, GROUP, STEPS = 8, 4, 3


@pytest.fixture(autouse=True)
def _port_cfg():
    """Default config, and the SIGTERM handler as it was: train_model
    installs the preemption handler (TRAIN.PREEMPT_SAVE)."""
    reset_port_cfg()
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)
    reset_port_cfg()


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


def _lockstep(dtype: str, steps: int):
    """(JAX losses, JAX state, port losses, port model) after ``steps``."""
    jcfg.defrost()
    jcfg.OPTIM.BASE_LR = tcfg.OPTIM.BASE_LR = 0.05
    np_dt = np.dtype(dtype)
    _, shapes = jax_resnet("resnet18")
    v = random_variables(shapes, seed=5)
    jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.dtype(dtype),
                                 bn_group=GROUP)
    cast = jax.tree.map(lambda a: jnp.asarray(a, np_dt), v)
    opt = jax_construct_optimizer()
    state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                       opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                       key=jax.random.key(0))
    step = jtrainer.make_train_step(jmodel, opt, topk=5)

    tdt = getattr(torch, dtype)
    model = tmodels.build_model("resnet18", num_classes=10, dtype=tdt, bn_group=GROUP)
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    model.to(tdt).train()
    topt = construct_optimizer(model)
    jl, tl = [], []
    for i in range(steps):
        b = stream_batch(i)
        state, m = step(state, {k: np.asarray(a, np_dt) if k == "image" else a
                                for k, a in b.items()})
        jl.append(float(m["loss"]))
        tb = {"image": torch.from_numpy(b["image"].astype(np_dt)),
              "label": torch.from_numpy(b["label"])}
        tl.append(float(trainer.train_step(model, topt, tb, 5)["loss"]))
    return jl, state, tl, model


def _compare(state, model, tol):
    n = compare_with_jax((state.params, state.batch_stats), model.state_dict(), tol)
    assert n == len(jax_path_map(state.params))


def test_f64_three_steps_lockstep_with_jax(x64):
    jl, state, tl, model = _lockstep("float64", STEPS)
    np.testing.assert_allclose(tl, jl, rtol=1e-7)
    _compare(state, model, 1e-7)
    assert tl[-1] < tl[0]  # a real trajectory, not a fixed point


def test_f32_one_step_matches_jax():
    jl, state, tl, model = _lockstep("float32", 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _compare(state, model, 2e-4)


def _set_both(**kv):
    jcfg.defrost()
    for key, val in kv.items():
        for c in (jcfg, tcfg):
            node = c
            *head, leaf = key.split("__")
            for h in head:
                node = node[h]
            node[leaf] = val


def test_dummy_loader_byte_identical_to_jax(monkeypatch):
    _set_both(MODEL__DUMMY_INPUT=True, TRAIN__BATCH_SIZE=4, TRAIN__IM_SIZE=16,
              TEST__BATCH_SIZE=48, RNG_SEED=3, TRAIN__WORKERS=2)
    from distribuuuu_tpu.data import loader as jloader

    monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 1)
    for jl, tl in ((jloader.construct_train_loader(), tloader.construct_train_loader()),
                   (jloader.construct_val_loader(), tloader.construct_val_loader())):
        jl.set_epoch(1)
        tl.set_epoch(1)
        assert len(jl) == len(tl)
        for jb, tb in zip(jl, tl, strict=True):
            for k in ("image", "label", "mask"):
                assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
    assert len(tl) == 6 and tb["mask"].sum() == 256 - 5 * 48  # the ragged, masked tail
    assert tb["image"].dtype == np.uint8


@pytest.mark.parametrize("policy,warmup", [("cos", 0), ("cos", 3), ("steps", 0),
                                           ("steps", 2)])
def test_epoch_lr_matches_jax(policy, warmup):
    _set_both(OPTIM__LR_POLICY=policy, OPTIM__WARMUP_EPOCHS=warmup, OPTIM__MAX_EPOCH=10,
              OPTIM__STEPS=[3, 6], OPTIM__MIN_LR=0.01)
    from distribuuuu_tpu.utils import schedules as jsched

    lrs = [tsched.get_epoch_lr(e) for e in range(10)]
    assert lrs == [jsched.get_epoch_lr(e) for e in range(10)]
    assert len(set(lrs)) > 1


def _toy_cfg(out_dir, max_epoch):
    tcfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
        "TRAIN.IM_SIZE", 32, "TRAIN.BATCH_SIZE", 2, "TEST.BATCH_SIZE", 64,
        "TRAIN.PRINT_FREQ", 64, "TRAIN.WORKERS", 2, "RNG_SEED", 0,
        "OPTIM.MAX_EPOCH", max_epoch, "OPTIM.BASE_LR", 0.05, "OUT_DIR", str(out_dir),
    ])


def _small_dummy_data(monkeypatch, n=16):
    """``n`` dummy samples a split instead of ``BATCH_SIZE × 64``: the
    loops and the resume are what these tests hold, not the epoch length."""
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        n, tcfg.TRAIN.IM_SIZE, raw_u8=True))


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, monkeypatch):
    _small_dummy_data(monkeypatch)
    _toy_cfg(tmp_path / "straight", 2)
    trainer.train_model()
    reset_port_cfg()
    _toy_cfg(tmp_path / "resumed", 1)
    trainer.train_model()
    assert not os.path.exists(ckpt.get_checkpoint(1))
    tcfg.OPTIM.MAX_EPOCH = 2
    trainer.train_model()  # auto-resumes at epoch 2
    a = ckpt.load_checkpoint(str(tmp_path / "straight/checkpoints/ckpt_ep_001.pth"))
    b = ckpt.load_checkpoint(str(tmp_path / "resumed/checkpoints/ckpt_ep_001.pth"))
    assert a["step"] == b["step"] == 16 and a["opt"]["count"] == b["opt"]["count"] == 16
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["opt"]["m"]:
        assert torch.equal(a["opt"]["m"][k], b["opt"]["m"][k]), k
    assert os.path.exists(tmp_path / "resumed/checkpoints/best.pth")


def _toy_model():
    model = tmodels.build_model("resnet18", num_classes=10, dtype=torch.float32,
                                bn_group=4)
    b = stream_batch(0)
    batch = {"image": torch.from_numpy(b["image"].astype(np.float32)),
             "label": torch.from_numpy(b["label"])}
    return model, batch


def test_eval_after_a_step_sees_the_new_weights():
    model, batch = _toy_model()
    x = batch["image"][:2]
    with torch.inference_mode():
        before = model.eval()(x)
    opt = construct_optimizer(model)
    trainer.train_step(model.train(), opt, batch, 5)
    with torch.inference_mode():
        after = model.eval()(x)
    fresh = tmodels.build_model("resnet18", num_classes=10, dtype=torch.float32)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = fresh.eval()(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


class _Loader:
    """Two batches; the first one's images are NaN."""

    def __init__(self, batch):
        bad = {**batch, "image": torch.full_like(batch["image"], float("nan"))}
        self.batches = [{k: v.numpy() for k, v in b.items()} for b in (bad, batch)]

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 2

    def __iter__(self):
        return iter(self.batches)


def test_nonfinite_raise_and_skip():
    from distribuuuu_tpu_torch.utils.logger import get_logger

    model, batch = _toy_model()
    tcfg.TRAIN.PRINT_FREQ = 1
    opt = construct_optimizer(model)
    with pytest.raises(NonFiniteLossError, match="epoch 1, batch ~1"):
        trainer.train_epoch(_Loader(batch), model, opt, {"step": 0}, 0, get_logger(),
                            torch.device("cpu"))

    model, batch = _toy_model()
    opt = construct_optimizer(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = trainer.train_step(model.train(), opt, {**batch, "image": batch["image"] * np.nan},
                           5, policy="skip")
    assert float(m["nonfinite"]) == 1.0 and opt.count == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    tcfg.TRAIN.NONFINITE = "skip"
    state = {"step": 0}
    interrupted, done, rec = trainer.train_epoch(_Loader(batch), model, opt, state, 0,
                                                 get_logger(), torch.device("cpu"))
    assert not interrupted and done == state["step"] == 2 and opt.count == 1
    assert len(rec["losses"]) == 1 and np.isfinite(rec["losses"][0])


UNPORTED = [
    # a model axis needs processes since it was ported; ZeRO still raises
    (["MESH.ZERO", 1], "MESH", "Parallel layouts beyond DP"),
    (["DEVICE.S2D_STEM", True], "S2D", "S2D stem"),
    *[(["FAULTS.ENABLED", True, f"FAULTS.{knob}", 0], f"FAULTS.{knob}", item)
      for knob, (_, item) in faults.REFUSED.items()],
]


# ids numbered as they were: case 0 (TRAIN.STEPS_PER_CALL) runs since folded
# steps were ported and case 2 (DATA.FORMAT tokens) since the LM plane was;
# the others keep their names
@pytest.mark.parametrize("opts,what,item", UNPORTED,
                         ids=[f"opts{i + (1 if i < 1 else 2)}-{w}-{it}"
                              for i, (_, w, it) in enumerate(UNPORTED)])
def test_unported_configurations_raise_with_roadmap_item(tmp_path, opts, what, item):
    """What the port does not run raises before any work, naming its
    ROADMAP item: mesh axes beyond data, the S2D stem, and each fault
    knob whose mechanism the port lacks."""
    _toy_cfg(tmp_path, 1)
    tcfg.merge_from_list(opts)
    with pytest.raises(NotImplementedError, match=rf"(?s){what}.*{item}"):
        trainer.train_model()


def test_more_processes_and_no_cuda_raise(tmp_path, monkeypatch):
    """A launch of two processes with a data axis of 1 is refused before
    any process group is joined; without CUDA the card is refused."""
    _toy_cfg(tmp_path, 1)
    tcfg.MESH.DATA = 1
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("WORLD_SIZE", "2"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=r"MESH.DATA=1.*number of processes \(2\)"):
        trainer.train_model()
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    tcfg.MESH.DATA = -1
    if not torch.cuda.is_available():
        tcfg.DEVICE.PLATFORM = "auto"
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            trainer.train_model()


def test_train_net_entry_point_on_cpu(tmp_path, monkeypatch):
    from distribuuuu_tpu_torch import test_net, train_net

    _small_dummy_data(monkeypatch)
    args = ["--cfg", "config/resnet18.yaml", "MODEL.DUMMY_INPUT", "True",
            "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
            "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "16", "TRAIN.BATCH_SIZE", "2",
            "TEST.BATCH_SIZE", "64", "OPTIM.MAX_EPOCH", "1", "RNG_SEED", "0",
            "OUT_DIR", str(tmp_path)]
    assert train_net.main(args) == 100.0  # every dummy label is 0
    reset_port_cfg()
    top1, _ = test_net.main(args + ["MODEL.WEIGHTS", str(tmp_path / "checkpoints/best.pth")])
    assert top1 == 100.0
    assert opt_update.update.launches == 0  # CPU tensors: no kernel


def test_preemption_saves_mid_epoch_and_the_resume_finishes(tmp_path, monkeypatch):
    from distribuuuu_tpu_torch.utils import preempt

    _small_dummy_data(monkeypatch)
    _toy_cfg(tmp_path, 1)
    calls = {"n": 0}

    def requested():  # SIGTERM arrives during the third step
        calls["n"] += 1
        return calls["n"] >= 3

    monkeypatch.setattr(preempt, "requested", requested)
    trainer.train_model()
    assert os.path.exists(ckpt.get_preempt_checkpoint(0))
    assert not os.path.exists(ckpt.get_checkpoint(0))
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    assert payload["step"] == 3 and payload["epoch"] == -1
    monkeypatch.setattr(preempt, "requested", lambda: False)
    trainer.train_model()  # resumes from the preempt save, re-runs epoch 1
    assert os.path.exists(ckpt.get_checkpoint(0))
    assert not os.path.exists(ckpt.get_preempt_checkpoint(0))  # superseded, pruned
    assert ckpt.load_checkpoint(ckpt.get_checkpoint(0))["step"] == 3 + 8


def test_resume_honours_load_opt_and_a_bad_checkpoint_names_its_path(tmp_path):
    """A garbage newest ``.pth`` (no manifest) is quarantined, its path in
    the warning, and the run resumes from ``ckpt_ep_000``, as the JAX
    package walks back; a direct load of the bad file still raises,
    naming its path."""
    import logging

    from distribuuuu_tpu_torch.utils.logger import get_logger

    _toy_cfg(tmp_path, 1)
    model, batch = _toy_model()
    opt = construct_optimizer(model)
    trainer.train_step(model.train(), opt, batch, 5)
    ckpt.save_checkpoint({"model": model.state_dict(), "opt": opt.state_dict(), "step": 1},
                         0, 0.0, is_best=False)
    fresh, _ = _toy_model()
    fopt = construct_optimizer(fresh)
    tcfg.TRAIN.LOAD_OPT = False
    assert trainer._resume(fresh, fopt, {"step": 0}, get_logger())[0] == 1
    assert fopt.count == 0 and torch.equal(fresh.fc.weight, model.fc.weight)
    tcfg.TRAIN.LOAD_OPT = True
    trainer._resume(fresh, fopt, {"step": 0}, get_logger())
    assert fopt.count == 1 and torch.equal(fopt.m[0], opt.m[0])
    with open(ckpt.get_checkpoint(1), "wb") as f:
        f.write(b"not a checkpoint")
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    get_logger().addHandler(handler)
    try:
        trainer.train_model()
    finally:
        get_logger().removeHandler(handler)
    bad = ckpt.get_checkpoint(1)
    assert any("quarantined" in m and bad in m for m in messages), messages
    assert any("resumed from" in m and "ckpt_ep_000.pth" in m for m in messages), messages
    assert not os.path.exists(bad) and os.path.exists(bad + ".corrupt")
    with pytest.raises(ckpt.CheckpointError, match="ckpt_ep_001.pth.corrupt"):
        ckpt.load_checkpoint(bad + ".corrupt")


@pytest.mark.parametrize("batch,group,world,error", [
    (4, 6, 3, NotImplementedError),  # a group of 6 cuts the 4-image batches
    (4, 3, 2, ValueError),  # 3 does not divide the global batch of 8
    (4, 8, 2, None),  # one group spans both ranks
    (4, 2, 2, None),  # two groups in each rank's batch
    (4, 16, 2, None),  # past the global batch: one group, SyncBN
])
def test_batch_geometry_is_over_the_global_batch(batch, group, world, error):
    tcfg.merge_from_list(["TRAIN.BATCH_SIZE", batch, "MODEL.BN_GROUP", group])
    if error is None:
        trainer.check_batch_geometry(world)
    else:
        with pytest.raises(error, match="cuts a process's batch|does not divide"):
            trainer.check_batch_geometry(world)
