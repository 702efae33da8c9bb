"""The port across processes (parallel/dist.py, the BatchNorm groups of
models/layers.py, trainer.py) against the JAX package on one device.

Processes: ``tests/torch_ddp_worker.py`` ranks over gloo on the CPU,
spawned here with the environment ``torchrun`` sets, each call under a
120 s limit. resnet18, 10 classes, 32², f64 state as
tests/test_torch_train.py sets it up, two steps of 4 images a rank
against JAX's ``make_train_step`` on one device at the global batch of 8:
the losses to 1e-7 relative, every parameter and running stat to 1e-7 of
its tensor's largest magnitude, for (a) ``MODEL.SYNCBN`` (one group of the
global batch), (b) ghost groups of 4 (a rank's batch), (c) ghost groups
of 8 (a group spanning both ranks) and (d) ghost groups of 4 over four
ranks of 2 images (each group two ranks: a sub-group all-reduce). Every
rank ends bitwise equal. The eval sums over 5 val images on two ranks
equal JAX's over the same sampler shards: 6 images, the repeat counted.
A NaN in rank 1's batch makes both ranks raise under ``raise`` and skip
together under ``skip``. A two-process ``train_net`` on a JPEG tree
writes its log and checkpoints from rank 0 only and auto-resumes on both.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_util import few_threads, jax_resnet, random_variables

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.data import loader as jloader
from distribuuuu_tpu.parallel import mesh as jmesh
from distribuuuu_tpu.parallel.partition import lowering as jlowering
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch.utils.weights import jax_path_map, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
GLOBAL, STEPS, LR = 8, 2, 0.05
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, argv: list[str], tmp, tag: str):
    """Start ``argv`` as ranks 0..world-1 of one launch, output to files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"{tag}.rank{r}.log"), "w+")
        procs.append((subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT,
                                       env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}),
                      log))
    return procs


def finish(procs) -> list[tuple[int, str]]:
    """Wait for every rank (all killed past ``TIMEOUT``); ``(returncode,
    output)`` a rank, each 0."""
    out = []
    try:
        for p, _ in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.seek(0)
            out.append((p.returncode, log.read()))
            log.close()
    for rc, text in out:
        assert rc == 0, text[-4000:]
    return out


def spawn(world: int, argv: list[str], tmp, tag: str) -> list[tuple[int, str]]:
    return finish(launch(world, argv, tmp, tag))


def stream_batch(step: int, n: int = GLOBAL):
    """tests/test_torch_train.py's batches: learnable labels."""
    rng = np.random.default_rng(10_000 + step)
    images = rng.standard_normal((n, 32, 32, 3))
    labels = ((images.mean(axis=(1, 2, 3)) * 40.0).astype(np.int64) % 10).astype(np.int32)
    images += labels[:, None, None, None] * 0.1
    return {"image": images, "label": labels, "mask": np.ones((n,), np.float64)}


def make_tree(root: str, n_val: int = 5) -> str:
    """``root/{train,val}/c{0,1}/*.jpg``: 8 train JPEGs a class and
    ``n_val`` val JPEGs, seeded, colours separable by class."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", n_val)):
        for i in range(n):
            c = i % 2
            d = os.path.join(root, split, f"c{c}")
            os.makedirs(d, exist_ok=True)
            w, h = (int(v) for v in rng.integers(36, 60, 2))
            arr = rng.integers(0, 128, (h, w, 3)) + np.asarray([120 * c, 60, 120 * (1 - c)])
            Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{i:03d}.jpg"), "JPEG", quality=90)
    return root


VAL_CFG = ["TEST.IM_SIZE", 36, "TRAIN.IM_SIZE", 32, "TEST.BATCH_SIZE", 2,
           "TRAIN.WORKERS", 1, "DATA.BACKEND", "pil", "MODEL.NUM_CLASSES", 10]


@pytest.fixture(scope="module")
def weights():
    _, shapes = jax_resnet("resnet18")
    return random_variables(shapes, seed=5)


def jax_steps(weights, group: int):
    """JAX's two steps on one device at the global batch, f64: the losses
    and the (params, batch_stats) after them."""
    jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.float64,
                                 bn_group=group)
    cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
    opt = jax_construct_optimizer()
    state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                       opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                       key=jax.random.key(0))
    step = jtrainer.make_train_step(jmodel, opt, topk=5)
    losses = []
    for i in range(STEPS):
        state, m = step(state, stream_batch(i))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, (state.params, state.batch_stats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """Every scenario of a two-rank and a four-rank launch, and, computed
    while they run, JAX's steps for the whole-batch BN (``bn_group`` 0)
    and ghost groups of 4 (under ``"jax"``)."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    torch.save(state_dict_from_jax(weights["params"], weights["batch_stats"]),
               os.path.join(tmp, "weights.pt"))
    batches = {}
    for i in range(STEPS):
        b = stream_batch(i)
        batches[f"image_{i}"], batches[f"label_{i}"] = b["image"], b["label"]
    np.savez(os.path.join(tmp, "batches.npz"), **batches)
    root = make_tree(os.path.join(tmp, "tree"))
    launches = []
    for world, scenarios in (
        (2, [{"name": "syncbn", "kind": "lockstep", "bn_group": 0, "steps": STEPS},
             {"name": "ghost4", "kind": "lockstep", "bn_group": 4, "steps": STEPS},
             {"name": "ghost8", "kind": "lockstep", "bn_group": 8, "steps": STEPS},
             {"name": "eval", "kind": "evaluate"},
             {"name": "raise", "kind": "nonfinite", "policy": "raise"},
             {"name": "skip", "kind": "nonfinite", "policy": "skip"}]),
        (4, [{"name": "span2", "kind": "lockstep", "bn_group": 4, "steps": STEPS}]),
    ):
        d = os.path.join(tmp, f"w{world}")
        os.makedirs(d)
        spec = {"weights": os.path.join(tmp, "weights.pt"),
                "batches": os.path.join(tmp, "batches.npz"), "out": d,
                "scenarios": scenarios,
                "cfg": ["OPTIM.BASE_LR", LR, "TRAIN.PRINT_FREQ", 1, "TEST.DATASET", root,
                        *VAL_CFG]}
        with open(os.path.join(d, "spec.json"), "w") as f:
            json.dump(spec, f)
        launches.append((world, d, launch(world, [WORKER, os.path.join(d, "spec.json")],
                                          d, "w")))
    jax.config.update("jax_enable_x64", True)
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        jcfg.OPTIM.BASE_LR = LR
        out = {"jax": {group: jax_steps(weights, group) for group in (0, 4)}}
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)
    for world, d, procs in launches:
        finish(procs)
        for r in range(world):
            for name, res in torch.load(os.path.join(d, f"rank{r}.pt"),
                                        weights_only=False).items():
                out.setdefault(name, []).append(res)
    out["tree"] = root
    return out


def compare(trees, sd: dict, tol: float) -> int:
    params, stats = trees
    paths = jax_path_map(params)
    n = 0
    for tree in (params, stats):
        for path, key in paths.items():
            node = tree
            for p in path:
                node = node.get(p) if isinstance(node, dict) else None
                if node is None:
                    break
            if node is None:
                continue
            a = np.asarray(node)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a
            np.testing.assert_allclose(sd[key].numpy(), a, rtol=tol,
                                       atol=tol * np.abs(a).max(), err_msg=key)
            n += 1
    return n


def assert_ranks_bitwise_equal(results):
    first = results[0]["state"]
    for other in results[1:]:
        for k, v in first.items():
            assert torch.equal(v, other["state"][k]), k


@pytest.mark.parametrize("name,group,world", [("syncbn", 0, 2), ("ghost4", 4, 2),
                                              ("ghost8", 0, 2), ("span2", 4, 4)])
def test_steps_across_ranks_match_jax_global_batch(runs, name, group, world):
    """``group`` names JAX's reference: ghost groups of 8 at the global
    batch of 8 are one group, as SyncBN's; four ranks of 2 with groups of
    4 are JAX's groups of 4."""
    results = runs[name]
    assert len(results) == world
    want_losses, want = runs["jax"][group]
    for res in results:
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-7)
    assert results[0]["losses"][-1] != results[0]["losses"][0]
    assert compare(want, results[0]["state"], 1e-7) > 100
    assert_ranks_bitwise_equal(results)


def test_eval_sums_equal_jax_over_the_same_shards(runs, weights, monkeypatch):
    """5 val images, 2 ranks of 3 (the head repeated), batches of 2: JAX's
    eval step over each rank's loader batches, summed, counts 6."""
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        for k, v in zip(VAL_CFG[::2], VAL_CFG[1::2]):
            node = jcfg
            *head, leaf = k.split(".")
            for h in head:
                node = node[h]
            node[leaf] = v
        jcfg.TEST.DATASET = runs["tree"]
        monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 1)
        jax.config.update("jax_enable_x64", True)
        jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
        state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                           opt_state=None, step=jnp.int32(0), key=jax.random.key(0))
        step = jax.jit(jlowering.make_eval_step(jmodel, topk=5))
        totals = {}
        for rank in (0, 1):
            monkeypatch.setattr(jmesh, "data_process_groups", lambda mesh=None, r=rank: (r, 2))
            for b in jloader.construct_val_loader():
                for k, v in step(state, b).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)
    n = totals["count"]
    assert n == 6
    for res in runs["eval"]:
        top1, topk, loss, count = res["result"]
        assert count == 6
        assert top1 == totals["correct1"] / n * 100 and topk == totals["correctk"] / n * 100
        np.testing.assert_allclose(loss, totals["loss_sum"] / n, rtol=1e-7)


def test_nonfinite_on_one_rank_raises_or_skips_on_both(runs):
    for res in runs["raise"]:
        assert res["raised"] and "batch ~1" in res["raised"]
    skip = runs["skip"]
    for res in skip:
        assert res["raised"] is None and res["done"] == 2 and res["count"] == 1
        assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])
    assert_ranks_bitwise_equal(skip)


def test_two_process_train_net_writes_from_rank0_and_resumes_on_both(tmp_path):
    root = make_tree(str(tmp_path / "tree"))
    out = str(tmp_path / "out")
    base = ["-m", "distribuuuu_tpu_torch.train_net", "--cfg", "config/resnet18.yaml",
            "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
            "MODEL.NUM_CLASSES", "10", "TRAIN.DATASET", root, "TEST.DATASET", root,
            "TRAIN.IM_SIZE", "32", "TEST.IM_SIZE", "36", "TRAIN.BATCH_SIZE", "4",
            "TEST.BATCH_SIZE", "4", "TRAIN.WORKERS", "1", "RNG_SEED", "0",
            "TRAIN.PRINT_FREQ", "1", "OUT_DIR", out]
    first = spawn(2, base + ["OPTIM.MAX_EPOCH", "1"], str(tmp_path), "e1")
    assert len(glob.glob(os.path.join(out, "*.log"))) == 1
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert ckpts == ["best.pth", "ckpt_ep_000.pth"]
    assert "saved checkpoint" in first[0][1] and "saved checkpoint" not in first[1][1]
    assert "decode backend: native" in first[0][1] and "2 process(es)" in first[1][1]
    second = spawn(2, base + ["OPTIM.MAX_EPOCH", "2"], str(tmp_path), "e2")
    for _, text in second:
        assert "resumed from" in text and "ckpt_ep_000.pth (epoch 1)" in text
    assert len(glob.glob(os.path.join(out, "*.log"))) == 2
    assert "ckpt_ep_001.pth" in os.listdir(os.path.join(out, "checkpoints"))
    payload = torch.load(os.path.join(out, "checkpoints", "ckpt_ep_001.pth"),
                         weights_only=True)
    assert payload["step"] == 4  # 16 images, 2 ranks of 4: 2 steps an epoch


LAUNCH_ENVS = {
    "torchrun": ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29400", "WORLD_SIZE": "8",
                  "RANK": "5"}, ("10.0.0.2", 29400, 8, 5)),
    "torchrun_one": ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "1"},
                     ("127.0.0.1", 29566, 1, 0)),
    "coordinator": ({"COORDINATOR_ADDRESS": "host7:1234", "NUM_PROCESSES": "4",
                     "PROCESS_ID": "3"}, ("host7", 1234, 4, 3)),
    "slurm": ({"SLURM_PROCID": "9", "SLURM_NTASKS": "16", "SLURM_NODELIST": "gpu[01-02]",
               "COORDINATOR_PORT": "4000"}, ("gpu01", 4000, 16, 9)),
    "slurm_one_task": ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, None),
    "none": ({}, None),
}


@pytest.mark.parametrize("mode", list(LAUNCH_ENVS))
def test_bootstrap_reads_the_three_launch_modes(monkeypatch, mode):
    """What ``setup_distributed`` would join, from the environment alone
    (Slurm's first host from ``scontrol show hostname``)."""
    from distribuuuu_tpu_torch.parallel import dist as tdist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS",
              "COORDINATOR_PORT", "NUM_PROCESSES", "PROCESS_ID", "SLURM_PROCID",
              "SLURM_NTASKS", "SLURM_NODELIST"):
        monkeypatch.delenv(k, raising=False)
    env, want = LAUNCH_ENVS[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []

    def scontrol(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="gpu01\ngpu02\n")

    monkeypatch.setattr(tdist.subprocess, "run", scontrol)
    assert tdist.bootstrap_env() == want
    assert tdist.env_world_size() == (want[2] if want else 1)
    assert calls == ([["scontrol", "show", "hostname", "gpu[01-02]"]] if mode == "slurm"
                     else [])
