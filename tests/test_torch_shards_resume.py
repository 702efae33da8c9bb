"""The exact mid-epoch resume of the port's shards format, on the CPU at
toy size: a preemption through the real path (``FAULTS.PREEMPT_AT_BATCH``,
``save_preempt_checkpoint`` with the loader's state, ``_resume``,
``_arm_exact_resume``, ``train_epoch``) continues at the exact next batch
and ends on the uninterrupted run's state; the port's counterpart of the
JAX package's ``tests/test_shards.py`` resume test.

resnet18, 3 classes, 16², batch 8, f64 state, on the JAX tests' corpus (48
train JPEGs, 6 steps an epoch) packed by the port: the resumed epoch's
parameters, BN buffers and momentum equal the uninterrupted run's, each
tensor bitwise or within ``RESUME_TOL`` of its largest magnitude, through
``train_epoch`` and through ``train_model``. Two gloo ranks
(``tests/torch_ddp_worker.py``, batch 2 each) preempted together and
resumed as one process at batch 2 consume the epoch's order exactly once.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_ddp import finish, launch
from torch_ddp_worker import train_model_consuming
from torch_port_util import few_threads, reset_port_cfg

from distribuuuu_tpu.data.shards import order as jorder
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data.loader import construct_train_loader
from distribuuuu_tpu_torch.data.shards import format as tformat
from distribuuuu_tpu_torch.data.shards import order as torder
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults, preempt
from distribuuuu_tpu_torch.utils.logger import get_logger
from distribuuuu_tpu_torch.utils.optim import construct_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
CPU = torch.device("cpu")
BLOCK, WINDOW, SEED = 4, 16, 1
RESUME_TOL = 1e-12  # of each tensor's largest magnitude; the runs are bitwise in practice


@pytest.fixture(autouse=True)
def _clean():
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


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_shards_resume")
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


def _cfg(pack: str, out_dir, batch: int = 8, *opts) -> list:
    return ["MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 3, "DEVICE.PLATFORM", "cpu",
            "DEVICE.COMPUTE_DTYPE", "float32", "DATA.FORMAT", "shards",
            "TRAIN.DATASET", pack, "TEST.DATASET", pack, "TRAIN.IM_SIZE", 16,
            "TEST.IM_SIZE", 18, "TRAIN.BATCH_SIZE", batch, "TEST.BATCH_SIZE", 12,
            "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", SEED,
            "DATA.SHARDS_BLOCK", BLOCK, "DATA.SHARDS_WINDOW", WINDOW, "OPTIM.MAX_EPOCH", 1,
            "OUT_DIR", str(out_dir), *opts]


PREEMPT = ["FAULTS.ENABLED", True, "FAULTS.PREEMPT_EPOCH", 0, "FAULTS.PREEMPT_AT_BATCH", 2]


def _model(seed: int = 0):
    model = trainer.build_model_from_cfg(torch.Generator().manual_seed(seed))
    model = model.to(torch.float64)
    return model, construct_optimizer(model)


def _assert_same_state(got: dict, want: dict) -> int:
    for k, w in want.items():
        g = got[k]
        if not torch.equal(g, w):
            scale = float(w.abs().max()) if w.is_floating_point() else 0.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=RESUME_TOL * scale, err_msg=k)
    return len(want)


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        get_logger().addHandler(self)
        return self.lines

    def __exit__(self, *exc):
        get_logger().removeHandler(self)


def test_preempted_epoch_continues_at_the_next_batch(pack, tmp_path):
    logger = get_logger()
    tcfg.merge_from_list(_cfg(pack, tmp_path / "ref"))
    model, opt = _model()
    loader = construct_train_loader()
    state = {"step": 0}
    interrupted, done, _ = trainer.train_epoch(loader, model, opt, state, 0, logger, CPU)
    assert not interrupted and done == len(loader) == 6
    ref_model, ref_m = model.state_dict(), dict(zip(opt.names, opt.m))

    reset_port_cfg()
    tcfg.merge_from_list(_cfg(pack, tmp_path / "run", 8, *PREEMPT))
    preempt.install()
    model, opt = _model()
    loader = construct_train_loader()
    state = {"step": 0}
    interrupted, done, _ = trainer.train_epoch(loader, model, opt, state, 0, logger, CPU)
    assert interrupted and done == 3  # the SIGTERM at batch 2 ends the epoch after it
    ckpt.save_preempt_checkpoint({"model": model.state_dict(), "opt": opt.state_dict(),
                                  "step": state["step"]}, 0, 0.0,
                                 data_state=loader.state_dict(done))

    preempt.reset()
    tcfg.FAULTS.ENABLED = False
    fresh, fopt = _model(seed=9)  # other weights: the resume must bring them
    state = {"step": 0}
    start_epoch, _, pending, data_state = trainer._resume(fresh, fopt, state, logger)
    assert start_epoch == 0 and pending is None and state["step"] == done
    assert data_state["cursor"] == done * 8 and data_state["epoch"] == 0
    loader = construct_train_loader()
    trainer._arm_exact_resume(loader, data_state, start_epoch, logger)
    assert loader.resume_skip(0) == done
    with _Messages() as lines:
        interrupted, total, rec = trainer.train_epoch(loader, fresh, fopt, state, 0, logger,
                                                      CPU)
    assert not interrupted and total == 6 and rec["steps"] == 3 and rec["start_batch"] == 3
    assert any("continuing epoch 1 at batch 4/6" in m for m in lines), lines
    assert state["step"] == 6
    assert _assert_same_state(fresh.state_dict(), ref_model) > 100
    assert _assert_same_state(dict(zip(fopt.names, fopt.m)), ref_m) == len(ref_m)


def test_a_cursor_of_another_epoch_or_corpus_reruns_the_epoch(pack, tmp_path):
    tcfg.merge_from_list(_cfg(pack, tmp_path))
    loader = construct_train_loader()
    loader.set_epoch(0)
    sd = loader.state_dict(2)
    with _Messages() as lines:
        trainer._arm_exact_resume(loader, sd, 1, get_logger())
        trainer._arm_exact_resume(loader, {**sd, "num_records": 5}, 0, get_logger())
    assert loader.resume_skip(0) == loader.resume_skip(1) == 0
    assert any("for epoch 0 but the resume starts at epoch 1" in m for m in lines)
    assert any("corpus changed" in m and "re-running epoch 1" in m for m in lines)


def _train_model_f64(monkeypatch, records=None) -> list[int]:
    build = trainer.build_model_from_cfg
    monkeypatch.setattr(trainer, "build_model_from_cfg",
                        lambda generator=None: build(generator).to(torch.float64))
    try:
        return train_model_consuming(records)
    finally:
        monkeypatch.setattr(trainer, "build_model_from_cfg", build)


def test_train_model_preempted_then_rerun_equals_one_run(pack, tmp_path, monkeypatch):
    """``train_model`` end to end at f64: preempted at batch 2, rerun, the
    final checkpoint equals an uninterrupted run's, and every sample of
    the epoch's order was trained once, in order."""
    tcfg.merge_from_list(_cfg(pack, tmp_path / "ref"))
    ref_order = _train_model_f64(monkeypatch)
    ref = ckpt.load_checkpoint(ckpt.get_checkpoint(0))

    reset_port_cfg()
    tcfg.merge_from_list(_cfg(pack, tmp_path / "run", 8, *PREEMPT))
    first = _train_model_f64(monkeypatch)
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    assert payload["data_state"].dtype == torch.uint8 and payload["step"] == 3
    assert ckpt.decode_data_state(payload["data_state"])["cursor"] == 24
    reset_port_cfg()
    faults.reset()
    preempt.reset()
    tcfg.merge_from_list(_cfg(pack, tmp_path / "run"))
    records = []
    with _Messages() as lines:
        rest = _train_model_f64(monkeypatch, records)
    assert any("continuing epoch 1 at batch 4/6" in m for m in lines), lines
    assert records[0]["steps"] == 3 and records[0]["eval_images"] == 12
    order = torder.global_order(48, SEED, 0, BLOCK, WINDOW).tolist()
    assert first + rest == ref_order == order
    got = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    assert got["step"] == ref["step"] == 6
    assert _assert_same_state(got["model"], ref["model"]) > 100
    assert _assert_same_state(got["opt"]["m"], ref["opt"]["m"]) == len(ref["opt"]["m"])
    assert not os.path.exists(ckpt.get_preempt_checkpoint(0))  # superseded, pruned


def test_two_ranks_preempted_resume_as_one_process_exactly_once(pack, tmp_path):
    """Two gloo ranks of batch 2 (global batch 4), SIGTERM at batch 3:
    they agree on the flag every 8 steps and leave together after 8
    (global cursor 32 of 48). One process of batch 2 resumes at batch 16
    of 24 (32 × 2 ÷ 2 = 8 × 2), and the ranks' strides interleaved, then
    the resumed run, are the epoch's order (JAX's ``global_order``)."""
    import json

    out = tmp_path / "out"
    base = _cfg(pack, out, 2, "OPTIM.BASE_LR", 0.001)  # f32 BN over 2 images: a gentle LR
    spec = {"out": str(tmp_path), "cfg": base, "scenarios": [
        {"name": "preempted", "kind": "shards_consumed",
         "cfg": ["FAULTS.ENABLED", True, "FAULTS.PREEMPT_EPOCH", 0,
                 "FAULTS.PREEMPT_AT_BATCH", 3]}]}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    finish(launch(2, [WORKER, str(tmp_path / "spec.json")], str(tmp_path), "shards"))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["preempted"]["consumed"]
             for r in range(2)]
    assert [len(c) for c in ranks] == [16, 16]
    tcfg.merge_from_list(base)
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    assert ckpt.decode_data_state(payload["data_state"])["cursor"] == 32
    records = []
    with _Messages() as lines:
        rest = train_model_consuming(records)
    assert any("continuing epoch 1 at batch 17/24" in m for m in lines), lines
    assert records[0]["start_batch"] == 16 and records[0]["steps"] == 8
    consumed = list(np.stack(ranks, 1).reshape(-1)) + rest
    order = jorder.global_order(48, SEED, 0, BLOCK, WINDOW)
    np.testing.assert_array_equal(consumed, order)
    assert sorted(consumed) == list(range(48))
