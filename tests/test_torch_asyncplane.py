"""The port's asynchronous plane (``asyncplane/committer.py``,
``asyncplane/evalloop.py``) on the CPU at toy size, mirroring the JAX
package's tests/test_asyncplane.py: the manifest strictly after the
payload under ``CHECKPOINT.ASYNC``, back-to-back saves serialised, a
failed commit surfacing at the join, the async payload bitwise equal to
the synchronous one, a preemption save draining the committer; concurrent
eval equal to a synchronous ``validate``, its relaunch guard and error
propagation, and the hard contract: training with concurrent eval and
async commits on is bitwise the synchronous run, eval metrics equal."""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import pytest
import torch
from torch_port_util import few_threads, reset_port_cfg

from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.asyncplane import committer, evalloop
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.resilience import manifest
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults
from distribuuuu_tpu_torch.utils.logger import get_logger


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    handler = signal.getsignal(signal.SIGTERM)
    yield
    try:
        committer.join_commits()
    except committer.AsyncCommitError:
        pass
    signal.signal(signal.SIGTERM, handler)
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _state(seed=0.0):
    return {"model": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + seed,
                      "m": torch.ones(3)},
            "opt": {"count": 1, "lr": 0.1, "m": {"w": torch.zeros(2, 3)}},
            "step": 7}


# ------------------------------------------------------------- committer


def test_manifest_written_strictly_last(tmp_path, monkeypatch):
    cfg.OUT_DIR = str(tmp_path)
    cfg.CHECKPOINT.ASYNC = True
    seen = {}

    def probe(path, epoch):
        seen.update(thread=__import__("threading").current_thread().name,
                    payload=os.path.getsize(path) > 0,
                    manifest=os.path.isfile(manifest.manifest_path(path)))

    monkeypatch.setattr(faults, "maybe_kill_mid_async_save", probe)
    path = ckpt.save_checkpoint(_state(), 0, 0.5, is_best=False)
    committer.join_commits()
    assert seen == {"thread": "dtpu-ckpt-committer", "payload": True, "manifest": False}
    assert manifest.verify_checkpoint(path) == (True, "ok")


def test_join_barrier_serializes_back_to_back_saves():
    order = []

    def slow():
        time.sleep(0.3)
        order.append("a")

    committer.submit_commit("a", slow)
    committer.submit_commit("b", lambda: order.append("b"))
    assert order[0] == "a"  # the second could only start after the first
    committer.join_commits()
    assert order == ["a", "b"] and not committer.pending_commits()
    assert [w[0] for w in committer.commit_windows()[-2:]] == ["a", "b"]


def test_commit_failure_surfaces_at_join():
    def boom():
        raise OSError("disk gone")

    committer.submit_commit("ckpt_ep_042.pth", boom)
    with pytest.raises(committer.AsyncCommitError, match="ckpt_ep_042"):
        committer.join_commits()
    committer.join_commits()  # the error is consumed; the barrier is clean again


def test_async_payload_bitwise_equals_sync(tmp_path):
    state = _state()
    cfg.OUT_DIR = str(tmp_path / "async")
    cfg.CHECKPOINT.ASYNC = True
    p_async = ckpt.save_checkpoint(state, 0, 0.5, is_best=True)
    state["model"]["w"] += 100.0  # the snapshot is a copy: later steps cannot reach it
    committer.join_commits()
    state["model"]["w"] -= 100.0
    cfg.CHECKPOINT.ASYNC = False
    cfg.OUT_DIR = str(tmp_path / "sync")
    p_sync = ckpt.save_checkpoint(state, 0, 0.5, is_best=True)
    with open(p_async, "rb") as fa, open(p_sync, "rb") as fs:
        a, b = torch.load(fa, weights_only=True), torch.load(fs, weights_only=True)
    assert a.keys() == b.keys()
    for part in ("model", "opt"):
        for k, v in a[part].items():
            if torch.is_tensor(v):
                assert torch.equal(v, b[part][k]), (part, k)
            elif isinstance(v, dict):
                assert all(torch.equal(v[n], b[part][k][n]) for n in v)
    assert a["step"] == b["step"] and a["best_acc1"] == b["best_acc1"]
    for out in ("async", "sync"):
        best = str(tmp_path / out / "checkpoints" / "best.pth")
        assert manifest.verify_checkpoint(best) == (True, "ok"), out


def test_preempt_save_drains_committer_first(tmp_path):
    order = []

    def slow():
        time.sleep(0.2)
        order.append("boundary_commit")

    cfg.OUT_DIR = str(tmp_path)
    cfg.CHECKPOINT.ASYNC = True
    committer.submit_commit("ckpt_ep_000.pth", slow)
    path = ckpt.save_preempt_checkpoint(_state(), 1, 0.0)
    order.append("preempt_saved")
    assert order == ["boundary_commit", "preempt_saved"]
    assert manifest.verify_checkpoint(path) == (True, "ok")  # committed synchronously


def test_find_last_valid_joins_the_committer(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    cfg.CHECKPOINT.ASYNC = True
    ckpt.save_checkpoint(_state(), 0, 0.0, is_best=False)
    assert ckpt.find_last_valid_checkpoint() == ckpt.get_checkpoint(0)
    assert not committer.pending_commits()


# -------------------------------------------------------- concurrent eval


def _eval_setup():
    cfg.merge_from_list(["MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", 16, "TEST.BATCH_SIZE", 8,
                         "TEST.PRINT_FREQ", 1])
    model = tmodels.build_model("resnet18", num_classes=10, dtype=torch.float32)
    loader = tloader.Loader(DummyDataset(length=20, size=16), batch_size=8, shuffle=False,
                            drop_last=False, workers=2)
    loader.set_epoch(0)
    return model, loader


def test_concurrent_eval_matches_sync_validate():
    model, loader = _eval_setup()
    cpu = torch.device("cpu")
    sync = trainer.validate(loader, model, 0, get_logger(), cpu)
    conc = evalloop.ConcurrentEval(lambda snap, ep: trainer.validate(
        loader, snap, ep, get_logger(), cpu, watch_preemption=False, quiet=True))
    model.train()
    conc.launch(model, 0)
    assert conc.in_flight
    ep, result, snap = conc.join()
    assert ep == 0 and not conc.in_flight and result == sync
    # the snapshot is its own module: same values, other tensors, no grad
    assert snap is not model and model.training and not snap.training
    for (k, a), b in zip(model.state_dict().items(), snap.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    assert not any(p.requires_grad for p in snap.parameters())
    assert all(u._cache is None for u in model.conv_units())  # the live model's cache untouched


def test_concurrent_eval_relaunch_guard_and_error_propagation():
    model = torch.nn.Linear(2, 2)

    def boom(snap, ep):
        raise RuntimeError("eval exploded")

    conc = evalloop.ConcurrentEval(boom)
    conc.launch(model, 3)
    with pytest.raises(RuntimeError, match="eval exploded"):
        conc.join()
    assert conc.join() is None
    ok = evalloop.ConcurrentEval(lambda snap, ep: (1.0, 2.0, 3.0, 4))
    ok.launch(model, 0)
    with pytest.raises(RuntimeError, match="still in flight"):
        ok.launch(model, 1)
    assert ok.join()[1] == (1.0, 2.0, 3.0, 4)


def _train(out_dir, monkeypatch, concurrent: bool):
    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        16, cfg.TRAIN.IM_SIZE, raw_u8=True))
    reset_port_cfg()
    cfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
        "TRAIN.IM_SIZE", 32, "TRAIN.BATCH_SIZE", 4, "TEST.BATCH_SIZE", 8,
        "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 0, "OPTIM.MAX_EPOCH", 2,
        "OPTIM.BASE_LR", 0.05, "OUT_DIR", str(out_dir),
        "TRAIN.CONCURRENT_EVAL", concurrent, "CHECKPOINT.ASYNC", concurrent])
    records = []
    best = trainer.train_model(records)
    return best, records


def test_concurrent_eval_and_async_commits_are_bitwise_the_sync_run(tmp_path, monkeypatch):
    best_a, rec_a = _train(tmp_path / "async", monkeypatch, True)
    best_s, rec_s = _train(tmp_path / "sync", monkeypatch, False)
    assert best_a == best_s
    assert [(r["epoch"], r["acc1"], r["eval_images"]) for r in rec_a] == \
        [(r["epoch"], r["acc1"], r["eval_images"]) for r in rec_s]
    assert [r["losses"] for r in rec_a] == [r["losses"] for r in rec_s]
    for name in ("ckpt_ep_000.pth", "ckpt_ep_001.pth", "best.pth"):
        pa = str(tmp_path / "async" / "checkpoints" / name)
        ps = str(tmp_path / "sync" / "checkpoints" / name)
        assert manifest.verify_checkpoint(pa)[0] and manifest.verify_checkpoint(ps)[0]
        a, b = ckpt.load_checkpoint(pa), ckpt.load_checkpoint(ps)
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), (name, k)
        if "opt" in a:
            for k, v in a["opt"]["m"].items():
                assert torch.equal(v, b["opt"]["m"][k]), (name, k)
            # the concurrent boundary save records the best as of the
            # previous eval: this epoch's is still in flight
            assert a["step"] == b["step"] and np.isfinite(a["best_acc1"])
