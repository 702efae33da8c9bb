"""The port's resilience layer on the CPU at toy size, mirroring the JAX
package's tests/test_resilience.py: manifests written last and verified
(``resilience/manifest.py``), the walk-back that quarantines a truncated
or uncommitted checkpoint to ``*.corrupt`` (``utils/checkpoint.py``),
the non-finite policies and the NaN drill through ``train_model``
(``resilience/supervisor.py``, ``FAULTS.NAN_STEP``), the loader's decode
faults, the stall watchdog, and the fault hooks (``utils/faults.py``);
the SIGKILL faults run in subprocesses."""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_port_util import few_threads, make_tree, reset_port_cfg

from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.resilience import manifest, supervisor
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults, preempt
from distribuuuu_tpu_torch.utils.logger import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    """Default config, no fault state, and SIGTERM's handler and the
    preemption flag as they were: the preemption fault delivers a real
    SIGTERM, whose flag would otherwise preempt every later run in this
    process."""
    reset_port_cfg()
    faults.reset()
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)
    preempt.reset()
    faults.reset()
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _tiny_state(seed: float = 0.0) -> dict:
    return {"model": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + seed,
                      "m": torch.ones(3)},
            "opt": {"count": 1, "m": {"w": torch.full((2, 3), 0.5 + seed)}},
            "step": 7}


def _truncate(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


class _Messages:
    """Captures the port logger's messages (it does not propagate)."""

    def __enter__(self):
        self.messages = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())
        get_logger().addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        get_logger().removeHandler(self.handler)


# ------------------------------------------------------- manifest commit


def test_save_commits_manifest_and_verifies(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    path = ckpt.save_checkpoint(_tiny_state(), epoch=0, best_acc1=1.0, is_best=True)
    man = manifest.read_manifest(path)
    assert man is not None and man["kind"] == "full" and man["epoch"] == 0
    assert "model/w" in man["tree"] and man["tree"]["model/w"]["shape"] == [2, 3]
    meta = man["files"][os.path.basename(path)]
    assert meta["size"] == os.path.getsize(path) and len(meta["sha256"]) == 64
    assert manifest.verify_checkpoint(path) == (True, "ok")
    best = ckpt.get_best_checkpoint()
    assert manifest.read_manifest(best)["kind"] == "weights"
    assert manifest.verify_checkpoint(best) == (True, "ok")


def test_manifest_is_written_after_the_payload_rename(tmp_path, monkeypatch):
    cfg.OUT_DIR = str(tmp_path)
    seen = {}

    def probe(path, epoch):
        seen.update(payload=os.path.isfile(path),
                    manifest=os.path.isfile(manifest.manifest_path(path)))

    monkeypatch.setattr(faults, "maybe_kill_mid_async_save", probe)
    path = ckpt.save_checkpoint(_tiny_state(), 0, 0.0, is_best=False)
    assert seen == {"payload": True, "manifest": False}
    assert manifest.verify_checkpoint(path)[0]


def test_verify_detects_truncation_and_missing_manifest(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    path = ckpt.save_checkpoint(_tiny_state(), 0, 0.0, is_best=False)
    _truncate(path)
    ok, reason = manifest.verify_checkpoint(path)
    assert not ok and "truncated" in reason, reason
    os.unlink(manifest.manifest_path(path))
    ok, reason = manifest.verify_checkpoint(path)
    assert not ok and "manifest" in reason, reason


# ---------------------------------------------- walk-back + quarantine


def test_walkback_quarantines_and_lands_on_previous_epoch(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    ckpt.save_checkpoint(_tiny_state(0.0), 0, 0.0, is_best=False)
    ckpt.save_checkpoint(_tiny_state(9.0), 1, 0.0, is_best=False)
    _truncate(ckpt.get_checkpoint(1))
    found = ckpt.find_last_valid_checkpoint()
    assert found == ckpt.get_checkpoint(0)
    names = sorted(os.listdir(ckpt.get_checkpoint_dir()))
    assert "ckpt_ep_001.pth.corrupt" in names and "ckpt_ep_001.pth" not in names, names
    assert "ckpt_ep_001.pth.corrupt.manifest.json" in names, names
    restored = ckpt.load_checkpoint(found)
    assert torch.equal(restored["model"]["w"], torch.arange(6.0).reshape(2, 3))
    # a second quarantine of the same name gets the next suffix
    ckpt.save_checkpoint(_tiny_state(9.0), 1, 0.0, is_best=False)
    _truncate(ckpt.get_checkpoint(1))
    ckpt.find_last_valid_checkpoint()
    assert "ckpt_ep_001.pth.corrupt.1" in os.listdir(ckpt.get_checkpoint_dir())


def test_partial_save_without_manifest_is_walked_past(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    ckpt.save_checkpoint(_tiny_state(), 0, 0.0, is_best=False)
    partial = ckpt.get_checkpoint(1)
    torch.save(_tiny_state(1.0), partial)  # a whole payload, never committed
    assert ckpt.get_last_checkpoint() == partial  # the raw scan would pick it
    assert ckpt.find_last_valid_checkpoint() == ckpt.get_checkpoint(0)
    assert "ckpt_ep_001.pth.corrupt" in os.listdir(ckpt.get_checkpoint_dir())


def test_all_corrupt_raises_no_valid(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    ckpt.save_checkpoint(_tiny_state(), 0, 0.0, is_best=False)
    _truncate(ckpt.get_checkpoint(0))
    with pytest.raises(ckpt.NoValidCheckpointError, match="none verified"):
        ckpt.find_last_valid_checkpoint()


def test_corrupt_preempt_walks_back_to_epoch_checkpoint(tmp_path):
    cfg.OUT_DIR = str(tmp_path)
    ckpt.save_checkpoint(_tiny_state(), 0, 0.0, is_best=False)
    ckpt.save_preempt_checkpoint(_tiny_state(1.0), epoch=1, best_acc1=0.0)
    assert ckpt.find_last_valid_checkpoint() == ckpt.get_preempt_checkpoint(1)
    _truncate(ckpt.get_preempt_checkpoint(1))
    assert ckpt.find_last_valid_checkpoint() == ckpt.get_checkpoint(0)


# ------------------------------------------------- train_model end to end


def _toy(out_dir, max_epoch=1, **extra):
    cfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10, "MODEL.DUMMY_INPUT", True,
        "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
        "TRAIN.IM_SIZE", 32, "TRAIN.BATCH_SIZE", 2, "TEST.BATCH_SIZE", 8,
        "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 0,
        "OPTIM.MAX_EPOCH", max_epoch, "OUT_DIR", str(out_dir),
        *[x for kv in extra.items() for x in kv]])


@pytest.fixture()
def small_data(monkeypatch):
    """16 dummy samples a split: 8 steps an epoch at batch 2."""
    monkeypatch.setattr(tloader, "_build_dataset", lambda train: DummyDataset(
        16, cfg.TRAIN.IM_SIZE, raw_u8=True))


def test_all_corrupt_falls_through_to_a_fresh_start(tmp_path, small_data):
    _toy(tmp_path)
    trainer.train_model()
    _truncate(ckpt.get_checkpoint(0))
    with _Messages() as messages:
        assert np.isfinite(trainer.train_model())
    assert any("falling through to a fresh start" in m for m in messages), messages
    assert manifest.verify_checkpoint(ckpt.get_checkpoint(0))[0]  # written anew


@pytest.mark.parametrize("mode", ["truncate", "partial"])
def test_corrupt_epoch_fault_is_walked_back(tmp_path, small_data, mode):
    """``FAULTS.CORRUPT_EPOCH`` damages ckpt_ep_001 after its commit; the
    next run quarantines it, resumes from ckpt_ep_000 and re-runs epoch 2."""
    _toy(tmp_path, 2, **{"FAULTS.ENABLED": True, "FAULTS.CORRUPT_EPOCH": 1,
                         "FAULTS.CORRUPT_MODE": mode})
    trainer.train_model()
    assert not manifest.verify_checkpoint(ckpt.get_checkpoint(1))[0]
    cfg.FAULTS.ENABLED = False
    with _Messages() as messages:
        trainer.train_model()
    assert any("resumed from" in m and "ckpt_ep_000.pth" in m for m in messages), messages
    names = os.listdir(ckpt.get_checkpoint_dir())
    assert "ckpt_ep_001.pth.corrupt" in names and "ckpt_ep_001.pth" in names, names
    assert manifest.verify_checkpoint(ckpt.get_checkpoint(1))[0]


# ------------------------------------------------------ non-finite policies


def test_nonfinite_monitor_policies():
    mon = supervisor.NonFiniteMonitor("skip", epoch=0)
    assert mon.observe(1.0, 0.0, batch=3) is False
    assert mon.observe(float("nan"), 1.0, batch=4) is True
    assert mon.skipped == 1
    for policy in ("raise", "rollback"):
        mon = supervisor.NonFiniteMonitor(policy, epoch=2)
        with pytest.raises(supervisor.NonFiniteLossError, match="epoch 3"):
            mon.observe(float("nan"), 1.0, batch=5)
    with pytest.raises(ValueError, match="TRAIN.NONFINITE"):
        supervisor.NonFiniteMonitor("bogus", epoch=0)


def test_nonfinite_policy_validated_in_config_checks():
    cfg.TRAIN.NONFINITE = "explode"
    with pytest.raises(ValueError, match="TRAIN.NONFINITE"):
        trainer.check_train_cfg()


def test_nan_injection_skip_policy_through_train_model(tmp_path, small_data):
    """``NAN_STEP 1`` under ``skip``: step 1's update is discarded (the
    optimizer counts 7 of 8 steps), the step cursor advances past it and
    training goes on finite."""
    _toy(tmp_path, **{"TRAIN.NONFINITE": "skip", "FAULTS.ENABLED": True,
                      "FAULTS.NAN_STEP": 1, "TRAIN.PRINT_FREQ": 1})
    records = []
    with _Messages() as messages:
        trainer.train_model(records)
    assert sum("update skipped" in m for m in messages) == 1, messages
    payload = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    assert payload["step"] == 8 and payload["opt"]["count"] == 7
    assert len(records[0]["losses"]) == 7 and all(np.isfinite(records[0]["losses"]))


def test_nan_rollback_policy_reloads_checkpoint(tmp_path, small_data):
    """The JAX package's drill: a deterministic NaN in epoch 1 (step 11, 8
    steps an epoch) rolls back to ckpt_ep_000 (logged), re-trips, and
    surfaces once ``MAX_ROLLBACKS`` 1 is spent; a clean rerun finishes
    from the same checkpoint."""
    _toy(tmp_path, 2, **{"TRAIN.NONFINITE": "rollback", "TRAIN.MAX_ROLLBACKS": 1,
                         "FAULTS.ENABLED": True, "FAULTS.NAN_STEP": 11})
    with _Messages() as messages:
        with pytest.raises(supervisor.NonFiniteLossError):
            trainer.train_model()
    assert sum("rolling back" in m for m in messages) == 1, messages
    assert any("rollback budget exhausted" in m for m in messages), messages
    assert sum("resumed from" in m and "ckpt_ep_000.pth" in m for m in messages) == 1
    cfg.FAULTS.ENABLED = False
    cfg.FAULTS.NAN_STEP = -1
    assert np.isfinite(trainer.train_model())
    assert "ckpt_ep_001.pth" in os.listdir(ckpt.get_checkpoint_dir())
    assert ckpt.load_checkpoint(ckpt.get_checkpoint(1))["step"] == 16


def test_rollback_before_any_checkpoint_reraises(tmp_path, small_data):
    _toy(tmp_path, **{"TRAIN.NONFINITE": "rollback", "FAULTS.ENABLED": True,
                      "FAULTS.NAN_STEP": 3})
    with _Messages() as messages:
        with pytest.raises(supervisor.NonFiniteLossError):
            trainer.train_model()
    assert any("nothing to roll back to" in m for m in messages), messages


# ------------------------------------------------------ loader resilience


def _tiny_loader():
    return tloader.Loader(DummyDataset(length=16, size=8), batch_size=4, shuffle=False,
                          drop_last=True, workers=1)


def test_loader_retry_recovers_transient_decode_error():
    cfg.DATA.RETRY_BACKOFF_S = 0.001
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.DECODE_ERROR_IDX = 3
    cfg.FAULTS.DECODE_ERROR_MODE = "once"
    batches = list(_tiny_loader())
    assert len(batches) == 4 and all(b["image"].shape == (4, 8, 8, 3) for b in batches)
    expected = np.random.default_rng(3).standard_normal((8, 8, 3), dtype=np.float32)
    np.testing.assert_array_equal(batches[0]["image"][3], expected)


def test_loader_skips_and_substitutes_persistently_corrupt_sample():
    cfg.DATA.RETRIES = 1
    cfg.DATA.RETRY_BACKOFF_S = 0.001
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.DECODE_ERROR_IDX = 5
    cfg.FAULTS.DECODE_ERROR_MODE = "always"
    batches = list(_tiny_loader())
    assert len(batches) == 4
    expected = np.random.default_rng(4).standard_normal((8, 8, 3), dtype=np.float32)
    np.testing.assert_array_equal(batches[1]["image"][1], expected)


def test_loader_fail_stop_when_skip_disabled():
    cfg.DATA.RETRIES = 0
    cfg.DATA.SKIP_CORRUPT = False
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.DECODE_ERROR_IDX = 5
    cfg.FAULTS.DECODE_ERROR_MODE = "always"
    with pytest.raises(RuntimeError, match="fail-stop"):
        list(_tiny_loader())


def test_decode_fault_hits_the_batch_decode_too():
    """A dataset with a batch decode (the native path) goes through the
    same hook before its batch call, then isolates the sample."""
    class Batched(DummyDataset):
        def load_batch(self, idxs, n_threads=1):
            return (np.stack([self[int(i)][0] for i in idxs]),
                    np.zeros(len(idxs), np.int32))

    cfg.DATA.RETRIES = 0
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.DECODE_ERROR_IDX = 5
    cfg.FAULTS.DECODE_ERROR_MODE = "always"
    loader = tloader.Loader(Batched(length=16, size=8), batch_size=4, shuffle=False,
                            drop_last=True, workers=1)
    batches = list(loader)
    expected = np.random.default_rng(4).standard_normal((8, 8, 3), dtype=np.float32)
    np.testing.assert_array_equal(batches[1]["image"][1], expected)


# ------------------------------------------------------ watchdogs and hooks


def test_heartbeat_flags_stall_and_quiet_when_beaten():
    hb = supervisor.Heartbeat(0.05)
    try:
        time.sleep(0.3)
        assert hb.stall_count >= 1
        stalled = hb.stall_count
        time.sleep(0.15)
        assert hb.stall_count == stalled  # one stall is flagged once
        hb.beat("recovered")
        time.sleep(0.02)
        assert hb.stall_count == stalled
    finally:
        hb.stop()
    hb = supervisor.Heartbeat(0.0)
    assert hb._thread is None
    hb.beat()
    hb.stop()


def test_watch_blocking_warns_once_past_its_timeout():
    with _Messages() as messages:
        with supervisor.watch_blocking("a slow join", 0.05):
            time.sleep(0.3)
        with supervisor.watch_blocking("a quick join", 0.0):
            pass
    assert sum("blocked in a slow join" in m for m in messages) == 1, messages


def test_stall_fault_trips_the_heartbeat(tmp_path, small_data):
    _toy(tmp_path, **{"TRAIN.STALL_TIMEOUT": 0.1, "FAULTS.ENABLED": True,
                      "FAULTS.STALL_AT_BATCH": 2, "FAULTS.STALL_S": 0.6})
    with _Messages() as messages:
        trainer.train_model()
    assert any("heartbeat: no step progress" in m and "batch 2" in m for m in messages)


def test_preempt_fault_saves_mid_epoch(tmp_path, small_data):
    _toy(tmp_path, **{"FAULTS.ENABLED": True, "FAULTS.PREEMPT_AT_BATCH": 2})
    trainer.train_model()
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    assert payload["step"] == 3 and payload["epoch"] == -1
    assert manifest.verify_checkpoint(ckpt.get_preempt_checkpoint(0))[0]


def test_slowdown_fault_sleeps_every_batch_of_its_epoch():
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.SLOWDOWN_MS = 30.0
    cfg.FAULTS.SLOWDOWN_EPOCH = 1
    t0 = time.perf_counter()
    faults.maybe_slowdown(0, 0)
    assert time.perf_counter() - t0 < 0.02
    faults.maybe_slowdown(1, 5)
    assert time.perf_counter() - t0 >= 0.03


def test_fault_modes_are_validated():
    cfg.FAULTS.ENABLED = True
    cfg.FAULTS.CORRUPT_MODE = "shred"
    with pytest.raises(ValueError, match="CORRUPT_MODE"):
        faults.validate_cfg()
    cfg.FAULTS.ENABLED = False
    faults.validate_cfg()  # a disarmed node is not read


# ------------------------------------------------------ SIGKILL faults


def _train_net(out_dir, *extra, timeout=240):
    """``train_net`` in a subprocess on a 16-image JPEG tree (4 steps an
    epoch at batch 4)."""
    root = os.path.join(out_dir, "tree")
    if not os.path.isdir(root):
        make_tree(root)
    args = [sys.executable, "-m", "distribuuuu_tpu_torch.train_net", "--cfg",
            "config/resnet18.yaml", "TRAIN.DATASET", root, "TEST.DATASET", root,
            "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
            "MODEL.NUM_CLASSES", "10", "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "36",
            "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8", "TRAIN.WORKERS", "1",
            "DATA.BACKEND", "pil", "TRAIN.PRINT_FREQ", "4", "RNG_SEED", "0",
            "OUT_DIR", str(out_dir), *map(str, extra)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_kill_mid_async_save_is_walked_back_in_a_subprocess(tmp_path):
    """SIGKILL between ckpt_ep_001.pth's rename and its manifest
    (``CHECKPOINT.ASYNC``): the file is in place and uncommitted; the
    restart quarantines it and resumes from ckpt_ep_000."""
    r = _train_net(tmp_path, "OPTIM.MAX_EPOCH", 2, "CHECKPOINT.ASYNC", "True",
                   "FAULTS.ENABLED", "True", "FAULTS.KILL_MID_ASYNC_SAVE", 1)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    d = os.path.join(tmp_path, "checkpoints")
    names = sorted(os.listdir(d))
    assert "ckpt_ep_001.pth" in names and "ckpt_ep_001.pth.manifest.json" not in names, names
    r = _train_net(tmp_path, "OPTIM.MAX_EPOCH", 2, "CHECKPOINT.ASYNC", "True")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "quarantined corrupt checkpoint" in r.stderr and "no committed manifest" in r.stderr
    assert "ckpt_ep_000.pth (epoch 1)" in r.stderr
    names = os.listdir(d)
    assert "ckpt_ep_001.pth.corrupt" in names and "ckpt_ep_001.pth" in names, names
    assert manifest.verify_checkpoint(os.path.join(d, "ckpt_ep_001.pth"))[0]


def test_kill_rank_sigkills_at_its_batch_in_a_subprocess(tmp_path):
    r = _train_net(tmp_path, "OPTIM.MAX_EPOCH", 1, "FAULTS.ENABLED", "True",
                   "FAULTS.KILL_RANK", 0, "FAULTS.KILL_AT_BATCH", 2)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    assert not os.path.exists(os.path.join(tmp_path, "checkpoints"))
