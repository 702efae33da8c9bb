"""One graph per step (``distribuuuu_tpu_torch/graphs.py``) on the CPU,
where every StepGraph runs its body eagerly on the same static buffers, at
toy size (resnet18, 10 classes, 32²; against JAX at f64, batches of 8 in
ghost BN groups of 4).

* Folding against the port: ``train_model`` with ``TRAIN.STEPS_PER_CALL
  3`` over 7 batches (two folds and a ragged tail of one) is bit for bit
  the per-step run, at f32 and f64: parameters, running stats, moments,
  ``count`` and ``step``.
* Folding against JAX: the port's folded step (two calls of 3 and one of
  1) against the JAX package's per-step ``make_train_step`` over the same
  7 batches at f64, every tensor within 1e-7 of its scale (JAX's own
  ``tests/test_step_folding.py`` shows its fold equals its per-step run).
* The loop: the flushes at ``PRINT_FREQ`` rounded to the fold, a
  preemption inside a fold leaving at its boundary with the shards cursor
  there and the rerun continuing at the next batch, ``NAN_STEP`` inside a
  fold under ``skip`` (bitwise the per-step run) and ``rollback``.
* The device-side skip against JAX's in-graph skip at f64 (a NaN batch
  between two clean ones, the three as one fold): params, moments, BN
  buffers and the optimizer count.
* Staged state: a dropout slot's masks are the key's eager masks, and a
  fold's staged scalar rows give the eager steps' bits (AdamW: c1 and c2
  move every row).
* The fault: ``FAULTS.RECOMPILE_*`` fires once at its (epoch, batch) with
  the capture function stood in for, the epoch's record counts the
  captures, and the knob raises on the CPU.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
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
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import graphs, trainer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.data.shards import format as tformat
from distribuuuu_tpu_torch.models import layers as tlayers
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.ops.cuda import opt_update
from distribuuuu_tpu_torch.resilience.supervisor import NonFiniteLossError
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults, preempt
from distribuuuu_tpu_torch.utils.logger import get_logger
from distribuuuu_tpu_torch.utils.optim import Optimizer, construct_optimizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

BATCH, GROUP, LR, TOL, CLASSES = 4, 2, 0.005, 1e-7, 10
# against JAX: ghost BN groups of 4. At groups of 2 the two frameworks
# part over a few steps (losses 3e-13, 2.5e-9, 5.8e-6, 6.6e-3 apart), and
# the first tensor that parts is layer 4's BN input gradient: at 32² layer
# 4 is 1x1, so a group is 2 values a channel, its one-pass variance falls
# to 1.9e-12 (s1²/var up to 7.9e8) and a 1-ulp change of its input moves
# dx by 2e-11. Fed the same input, the two BN layers agree to 1.4e-14;
# the ulps come from the convolutions' summation orders upstream, and
# after one step the gradients (momentum traces) are 1.3e-10 apart against
# 3e-13 at groups of 4 (test_ghost_bn_groups_of_2_part_by_conditioning).
J_BATCH, J_GROUP = 8, 4


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    faults.reset()
    preempt.reset()
    yield
    reset_port_cfg()
    faults.reset()
    preempt.reset()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


class _Labelled(DummyDataset):
    """The dummy images with labels spread over the classes."""

    def __getitem__(self, idx: int):
        return super().__getitem__(idx)[0], idx % CLASSES


def _toy_cfg(tmp_path, fold: int, batches: int = 7, *opts) -> None:
    tcfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", CLASSES, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32", "TRAIN.IM_SIZE", 32,
        "TRAIN.BATCH_SIZE", BATCH, "TEST.BATCH_SIZE", 8, "TRAIN.PRINT_FREQ", 2,
        "TRAIN.WORKERS", 1, "RNG_SEED", 1, "OPTIM.MAX_EPOCH", 1, "MODEL.BN_GROUP", GROUP,
        "TRAIN.STEPS_PER_CALL", fold, "OPTIM.BASE_LR", LR, "OUT_DIR", str(tmp_path),
        *opts])
    tcfg.TRAIN.DATASET = str(batches)  # read back by _dataset


def _dataset(train: bool):
    n = int(tcfg.TRAIN.DATASET) * BATCH if train else 8
    return _Labelled(n, tcfg.TRAIN.IM_SIZE, raw_u8=True)


def _run_model(tmp_path, monkeypatch, fold: int, dtype=torch.float32, *opts) -> dict:
    """``train_model`` at ``fold``; the last epoch checkpoint's payload."""
    reset_port_cfg()
    _toy_cfg(tmp_path / f"k{fold}", fold, 7, *opts)
    monkeypatch.setattr(tloader, "_build_dataset", _dataset)
    if dtype == torch.float64:
        tcfg.DEVICE.COMPUTE_DTYPE = "float64"
        build = trainer.build_model_from_cfg
        monkeypatch.setattr(trainer, "build_model_from_cfg",
                            lambda generator=None: build(generator).to(torch.float64))
    records = []
    trainer.train_model(records)
    monkeypatch.undo()
    return {"ckpt": ckpt.load_checkpoint(ckpt.get_checkpoint(0)), "records": records}


def _same(a: dict, b: dict) -> int:
    for k, v in b.items():
        assert torch.equal(a[k], v), k
    return len(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fold_is_bitwise_the_per_step_run(tmp_path, monkeypatch, dtype):
    one = _run_model(tmp_path, monkeypatch, 1, dtype)
    three = _run_model(tmp_path, monkeypatch, 3, dtype)
    a, b = three["ckpt"], one["ckpt"]
    assert a["step"] == b["step"] == a["opt"]["count"] == 7
    assert _same(a["model"], b["model"]) > 100
    assert _same(a["opt"]["m"], b["opt"]["m"]) == len(b["opt"]["m"])
    assert next(iter(a["model"].values())).dtype == dtype
    assert three["records"][0]["losses"] == one["records"][0]["losses"]


@pytest.fixture(scope="module")
def weights():
    _, shapes = jax_resnet("resnet18")
    return random_variables(shapes, seed=5)


def _port(weights, policy: str = "raise", fold: int = 3, group: int = J_GROUP):
    model = tmodels.build_model("resnet18", num_classes=CLASSES, dtype=torch.float64,
                                bn_group=group)
    model.load_state_dict(state_dict_from_jax(weights["params"], weights["batch_stats"]))
    model = model.to(torch.float64).train()
    tcfg.OPTIM.BASE_LR = LR
    tcfg.TRAIN.STEPS_PER_CALL = fold
    opt = construct_optimizer(model)
    return model, opt, trainer.TrainStep(model, opt, 5, policy, 1, fold, torch.device("cpu"))


def _port_batch(b):
    return {"image": torch.from_numpy(b["image"]).to(torch.float64),
            "label": torch.from_numpy(b["label"])}


def _jax_steps(weights, batches, policy: str = "raise", group: int = J_GROUP):
    """The JAX package's per-step ``make_train_step`` at f64 over
    ``batches``: (params, batch_stats, trace, count, losses)."""
    jax.config.update("jax_enable_x64", True)
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        jcfg.OPTIM.BASE_LR = LR
        jcfg.TRAIN.NONFINITE = policy
        jmodel = jmodels.build_model("resnet18", num_classes=CLASSES, dtype=jnp.float64,
                                     bn_group=group)
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
        opt = jax_construct_optimizer()
        state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                           opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                           key=jax.random.key(0))
        step = jtrainer.make_train_step(jmodel, opt, topk=5)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return (jax.tree.map(np.asarray, (state.params, state.batch_stats,
                                          jax_trace(state.opt_state))), _jax_count(state),
                losses)
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)


def _jax_count(state) -> int:
    """optax's step count in the SGD state."""
    counts = [leaf for path, leaf in jax.tree_util.tree_leaves_with_path(state.opt_state)
              if "count" in jax.tree_util.keystr(path)]
    return int(counts[0])


def test_fold_matches_jax_per_step_at_f64(weights):
    batches = [stream_batch(i, J_BATCH) for i in range(7)]
    (params, stats, trace), count, jlosses = _jax_steps(weights, batches)
    model, opt, step = _port(weights)
    losses = []
    for part in (batches[:3], batches[3:6], batches[6:]):
        out = step([_port_batch(b) for b in part], [False] * len(part))
        losses.extend(out[:, 0].tolist())
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert compare_with_jax((params, stats), model.state_dict(), TOL) > 100
    assert compare_with_jax((trace,), dict(zip(opt.names, opt.m)), TOL) == len(opt.names)
    assert opt.count == count == 7


def test_device_skip_equals_jax_in_graph_skip_at_f64(weights):
    batches = [stream_batch(i, J_BATCH) for i in range(3)]
    batches[1] = {**batches[1], "image": batches[1]["image"] * np.nan}
    (params, stats, trace), count, jlosses = _jax_steps(weights, batches, "skip")
    model, opt, step = _port(weights, "skip")
    out = step([_port_batch(b) for b in batches], [False] * 3)
    assert out[:, 3].tolist() == [0.0, 1.0, 0.0]
    np.testing.assert_allclose(out[[0, 2], 0].tolist(), [jlosses[0], jlosses[2]], rtol=TOL)
    assert compare_with_jax((params, stats), model.state_dict(), TOL) > 100
    assert compare_with_jax((trace,), dict(zip(opt.names, opt.m)), TOL) == len(opt.names)
    assert opt.count == count == 2


def _layer4_bn_inputs(weights, group: int) -> dict:
    """Each layer-4 BN's (input, running mean, scale, bias) in the f64
    port's train forward of the first lockstep batch at ghost groups of
    ``group``."""
    model = _port(weights, group=group)[0]
    caught = {}

    def hook(name):
        def grab(mod, args, out):
            caught[name] = (args[0].detach().clone(), mod.running_mean.clone(),
                            mod.weight.detach().clone(), mod.bias.detach().clone())
        return grab

    for name, m in model.named_modules():
        if isinstance(m, tlayers.BatchNorm) and name.startswith("layer4"):
            m.register_forward_hook(hook(name))
    model(_port_batch(stream_batch(0, J_BATCH))["image"])
    return caught


def _bn_pair(x, stats, group: int, dy):
    """(y, dx) of the port's BatchNorm and of JAX's on the same f64 input
    and upstream gradient ``dy``."""
    from distribuuuu_tpu.models.layers import _BNCore

    rm, w, b = stats
    bn = tlayers.BatchNorm(x.shape[-1], group_size=group).double()
    with torch.no_grad():
        bn.running_mean.copy_(rm)
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xt = x.clone().requires_grad_(True)
    y = bn(xt, torch.float64)
    (y * dy).sum().backward()
    jax.config.update("jax_enable_x64", True)
    try:
        core = _BNCore(group_size=group, dtype=jnp.float64)
        vs = {"params": {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())},
              "batch_stats": {"mean": jnp.asarray(rm.numpy()),
                              "var": jnp.ones(x.shape[-1], jnp.float64)}}
        yj, vjp = jax.vjp(lambda v: core.apply(vs, v, train=True, mutable=["batch_stats"])[0],
                          jnp.asarray(x.numpy()))
        gx = vjp(jnp.asarray(dy.numpy()))[0]
        return (y.detach().numpy(), xt.grad.numpy()), (np.asarray(yj), np.asarray(gx))
    finally:
        jax.config.update("jax_enable_x64", False)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_ghost_bn_groups_of_2_part_by_conditioning(weights):
    """The groups-of-2 parting is rounding, amplified: (1) each layer-4 BN,
    fed the port's own input, gives JAX's output and input gradient within
    f64 rounding (the same formulation); (2) at groups of 2 that layer
    moves its input gradient by more than 1e-12 for a 1-ulp input change,
    at groups of 4 by less; (3) one lockstep step at groups of 2 then
    keeps the loss to 1e-12 and the gradients (the momentum traces) to
    1e-9 of their scale, the bound the first step reaches (1.3e-10
    measured)."""
    rng = np.random.default_rng(0)
    sensitivity = {}
    for group in (2, 4):
        worst = 0.0
        for x, *stats in _layer4_bn_inputs(weights, group).values():
            dy = torch.from_numpy(rng.standard_normal(tuple(x.shape)))
            (y, dx), (yj, dxj) = _bn_pair(x, stats, group, dy)
            assert _rel(y, yj) < 1e-14
            assert _rel(dx, dxj) < 1e-13
            up = torch.nextafter(x, torch.full_like(x, np.inf))
            (_, dx_up), _ = _bn_pair(up, stats, group, dy)
            worst = max(worst, _rel(dx_up, dx))
        sensitivity[group] = worst
    assert sensitivity[2] > 1e-12 > sensitivity[4], sensitivity

    batch = stream_batch(0, J_BATCH)
    (_, _, trace), _, jlosses = _jax_steps(weights, [batch], group=2)
    _, opt, step = _port(weights, fold=1, group=2)
    out = step([_port_batch(batch)], [False])
    np.testing.assert_allclose(out[0, 0].item(), jlosses[0], rtol=1e-12)
    assert compare_with_jax((trace,), dict(zip(opt.names, opt.m)), 1e-9) == len(opt.names)


def test_variance_clamp_takes_jnp_maximum_gradient_at_a_tie():
    """BatchNorm's and LayerNorm's variance clamp (``layers.clamp0``)
    passes half the gradient at an exact 0, as ``jnp.maximum`` does in the
    JAX layers (``clamp_min`` would pass all of it)."""
    v = np.asarray([-1.0, 0.0, 1.0])
    want = jax.grad(lambda a: jnp.maximum(a, 0.0).sum())(jnp.asarray(v, jnp.float32))
    vt = torch.tensor(v, dtype=torch.float32, requires_grad=True)
    tlayers.clamp0(vt).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(want))
    assert vt.grad.tolist() == [0.0, 0.5, 1.0]


def _epoch(tmp_path, fold: int, batches: int, *opts):
    """``train_epoch`` over ``batches`` toy batches at ``fold``: (model,
    optimizer, record)."""
    reset_port_cfg()
    _toy_cfg(tmp_path, fold, batches, *opts)
    loader = tloader.Loader(_dataset(True), BATCH, shuffle=False, drop_last=True, workers=1)
    model = trainer.build_model_from_cfg()
    opt = construct_optimizer(model)
    state = {"step": 0}
    out = trainer.train_epoch(loader, model, opt, state, 0, get_logger(), torch.device("cpu"))
    return model, opt, out, state


def test_flushes_at_print_freq_rounded_to_the_fold(tmp_path):
    _, _, (interrupted, done, rec), state = _epoch(tmp_path, 3, 10, "TRAIN.PRINT_FREQ", 4)
    assert not interrupted and done == state["step"] == 10 == rec["steps"]
    assert [d for d, _ in rec["flushes"]] == [6, 9, 10]  # done % 4 < 3, or the end
    assert len(rec["losses"]) == len(rec["step_t"]) == len(rec["data_wait_s"]) == 10


@pytest.mark.parametrize("policy", ["skip", "rollback"])
def test_nan_step_inside_a_fold(tmp_path, monkeypatch, policy):
    nan = ["TRAIN.NONFINITE", policy, "FAULTS.ENABLED", True, "FAULTS.NAN_STEP", 4]
    if policy == "skip":
        m3, o3, (_, _, r3), _ = _epoch(tmp_path / "k3", 3, 7, *nan)
        m1, o1, (_, _, r1), _ = _epoch(tmp_path / "k1", 1, 7, *nan)
        assert o3.count == o1.count == 6 and r3["losses"] == r1["losses"]
        assert len(r3["losses"]) == 6
        assert _same(m3.state_dict(), m1.state_dict()) > 100
        assert all(torch.equal(a, b) for a, b in zip(o3.m, o1.m))
        return
    # rollback: epoch 1 commits, the NaN at step 8 (epoch 2's second
    # fold) rolls back to it, reproduces, and exhausts the budget
    reset_port_cfg()
    _toy_cfg(tmp_path, 3, 7, "TRAIN.NONFINITE", "rollback", "TRAIN.MAX_ROLLBACKS", 1,
             "FAULTS.ENABLED", True, "FAULTS.NAN_STEP", 10, "OPTIM.MAX_EPOCH", 2)
    monkeypatch.setattr(tloader, "_build_dataset", _dataset)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    get_logger().addHandler(handler)
    try:
        with pytest.raises(NonFiniteLossError):
            trainer.train_model()
    finally:
        get_logger().removeHandler(handler)
    assert any("rolling back" in m for m in lines), lines
    assert ckpt.load_checkpoint(ckpt.get_checkpoint(0))["step"] == 7


def test_skip_inside_a_fold_keys_dropout_by_the_step_cursor(tmp_path):
    """efficientnet_b0 (dropout 0.2 before its head) under ``skip`` with a
    NaN at step 4, the middle of the second fold of 3: the fold equals the
    per-step run bit for bit. The masks are keyed by the step cursor, which
    moves on over the skipped step (JAX's ``fold_in(key, state.step)``),
    not by the optimizer's count, which does not."""
    nan = ["MODEL.ARCH", "efficientnet_b0", "TRAIN.NONFINITE", "skip", "FAULTS.ENABLED", True,
           "FAULTS.NAN_STEP", 4]
    m3, o3, (_, _, r3), s3 = _epoch(tmp_path / "k3", 3, 7, *nan)
    m1, o1, (_, _, r1), s1 = _epoch(tmp_path / "k1", 1, 7, *nan)
    assert s3["step"] == s1["step"] == 7 and o3.count == o1.count == 6
    assert len(r3["losses"]) == 6 and r3["losses"] == r1["losses"]
    assert _same(m3.state_dict(), m1.state_dict()) > 100
    assert all(torch.equal(a, b) for a, b in zip(o3.m, o1.m))


def test_a_graph_is_freed_with_its_owner():
    """No reference cycle runs through a StepGraph: with the garbage
    collector off, dropping its train step or its drained serving engine
    frees the graph at once (on the CPU the graphs are built as on the
    card and run their bodies eagerly)."""
    import gc
    import weakref

    from distribuuuu_tpu_torch.serve.engine import Engine

    model = tmodels.build_model("resnet18", num_classes=CLASSES, dtype=torch.float32)
    batch = {"image": torch.zeros((BATCH, 32, 32, 3), dtype=torch.uint8),
             "label": torch.zeros(BATCH, dtype=torch.int32)}
    gc.collect()
    gc.disable()
    try:
        step = trainer.TrainStep(model.train(), construct_optimizer(model), 5)
        step([batch], [False])
        ref = weakref.ref(next(iter(step._graphs.values())))
        del step
        assert ref() is None
        eng = Engine(model, 32, device="cpu", max_batch=2, bucket_sizes=[2]).start()
        ref = weakref.ref(eng._graphs[2])
        eng.drain()
        del eng
        assert ref() is None
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_graphs_pack")
    rng = np.random.default_rng(0)
    for split, per_cls in (("train", 16), ("val", 4)):
        for cls in ("class_a", "class_b", "class_c"):
            d = root / "src" / split / cls
            d.mkdir(parents=True)
            for i in range(per_cls):
                arr = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.jpg", quality=90)
    tformat.pack_imagefolder(str(root / "src"), str(root / "shards"), target_bytes=16 * 1024)
    return str(root / "shards")


def _shards_cfg(pack: str, out_dir, *opts) -> list:
    return ["MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 3, "DEVICE.PLATFORM", "cpu",
            "DEVICE.COMPUTE_DTYPE", "float32", "DATA.FORMAT", "shards",
            "TRAIN.DATASET", pack, "TEST.DATASET", pack, "TRAIN.IM_SIZE", 16,
            "TEST.IM_SIZE", 18, "TRAIN.BATCH_SIZE", 8, "TEST.BATCH_SIZE", 12,
            "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 3,
            "TRAIN.STEPS_PER_CALL", 2, "OPTIM.MAX_EPOCH", 1, "OUT_DIR", str(out_dir), *opts]


def test_preemption_inside_a_fold_leaves_at_its_boundary(pack, tmp_path):
    """SIGTERM at batch 2 (the first of the second fold of 2): the fold
    runs, the epoch leaves after 4 batches with the shards cursor there,
    and the rerun continues at batch 5 and ends equal to one run."""
    from torch_ddp_worker import train_model_consuming

    tcfg.merge_from_list(_shards_cfg(pack, tmp_path / "ref"))
    ref_order = train_model_consuming()
    ref = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    reset_port_cfg()
    tcfg.merge_from_list(_shards_cfg(pack, tmp_path / "run", "FAULTS.ENABLED", True,
                                     "FAULTS.PREEMPT_EPOCH", 0, "FAULTS.PREEMPT_AT_BATCH", 2))
    first = train_model_consuming()
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    assert payload["step"] == payload["opt"]["count"] == 4
    assert ckpt.decode_data_state(payload["data_state"])["cursor"] == 32
    reset_port_cfg()
    faults.reset()
    preempt.reset()
    tcfg.merge_from_list(_shards_cfg(pack, tmp_path / "run"))
    records = []
    rest = train_model_consuming(records)
    assert records[0]["start_batch"] == 4 and records[0]["steps"] == 2
    assert first + rest == ref_order
    got = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    assert got["step"] == ref["step"] == 6
    assert _same(got["model"], ref["model"]) > 100


def test_staged_dropout_masks_are_the_keys_eager_masks():
    layer = tlayers.Dropout(0.3).train()
    x = torch.randn(8, 40)
    slot = tlayers.DropoutSlot()
    for key in ((0, 0, 0), (0, 5, 1), (2, 5, 1)):
        slot.set_key(key)
        assert torch.equal(layer(x, slot), layer(x, key)), key
    assert slot.mask(layer, x).dtype == torch.bool


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_staged_scalar_rows_give_the_eager_steps_bits(kind):
    h = opt_update.Hyper(kind=kind, wd=5e-5, mom=0.9 if kind == "sgd" else 0.0,
                         nesterov=kind == "sgd")
    rows = opt_update.scalar_rows(h, 0.1, 4, 3)
    for i, row in enumerate(rows):
        s = opt_update.scalars(h, 0.1, 4 + i)
        assert row.tolist() == [np.float32(s[k]) for k in opt_update.SCALARS]
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(7, 5, generator=g), torch.randn(11, generator=g)]
    grads = [[torch.randn_like(p) for p in params] for _ in range(3)]
    a = Optimizer([(str(i), p.clone()) for i, p in enumerate(params)], h, 0.1, fold=3)
    b = Optimizer([(str(i), p.clone()) for i, p in enumerate(params)], h, 0.1, fold=3)
    for gs in grads:
        a.step(gs)
    b.stage(3)
    b.row.zero_()
    for gs in grads:
        b.apply(gs)
    b.advance(3)
    assert int(b.row) == 3 and a.count == b.count == 3
    for x, y in zip(a.params + (a.m or []) + (a.v or []), b.params + (b.m or []) + (b.v or [])):
        assert torch.equal(x, y)
    b.row.zero_()
    b.apply(grads[0], skip=torch.ones(()))
    assert int(b.row) == 0
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)


def test_recompile_fires_once_at_its_batch(tmp_path, monkeypatch):
    calls = []

    def fake(n, device):
        calls.append((n, torch.device(device).type))
        graphs.captures += n
        return n

    monkeypatch.setattr(graphs, "capture_trivial", fake)
    tcfg.merge_from_list(["FAULTS.ENABLED", True, "FAULTS.RECOMPILE_EPOCH", 1,
                          "FAULTS.RECOMPILE_AT_BATCH", 2, "FAULTS.RECOMPILE_N", 5])
    fired = [(e, b) for e in range(3) for b in range(4)
             if faults.maybe_recompile(e, b, "cpu")]
    assert fired == [(1, 2)] and calls == [(5, "cpu")]
    assert faults.maybe_recompile(1, 2, "cpu") == 0  # one-shot
    faults.reset()
    _, _, (_, _, rec), _ = _epoch(tmp_path, 1, 4, "FAULTS.ENABLED", True,
                                  "FAULTS.RECOMPILE_EPOCH", 0, "FAULTS.RECOMPILE_AT_BATCH", 1,
                                  "FAULTS.RECOMPILE_N", 12)
    assert rec["captures"] == 12 and rec["steps"] == 4


def test_recompile_knob_raises_on_the_cpu(tmp_path):
    _toy_cfg(tmp_path, 1, 2, "FAULTS.ENABLED", True, "FAULTS.RECOMPILE_AT_BATCH", 1)
    with pytest.raises(ValueError, match="needs the card"):
        trainer.train_model()
    with pytest.raises(ValueError, match="needs the card"):
        graphs.capture_trivial(2, "cpu")


def test_step_graph_on_the_cpu_runs_its_body_on_the_static_buffers():
    x = torch.zeros(3)
    g = graphs.StepGraph(lambda: x * 2, {"x": x}, device="cpu")
    assert not g.graphed
    assert torch.equal(g(x=torch.tensor([1.0, 2.0, 3.0])), torch.tensor([2.0, 4.0, 6.0]))
    assert torch.equal(x, torch.tensor([1.0, 2.0, 3.0]))
    before = kernel_tier.launch_counts()
    kernel_tier.add_launches({"opt_update": 2, "decode_attn": 1})
    after = kernel_tier.launch_counts()
    assert after["opt_update"] - before["opt_update"] == 2 and set(after) == set(before)
    kernel_tier.add_launches({"opt_update": -2, "decode_attn": -1})
    assert kernel_tier.launch_counts() == before
