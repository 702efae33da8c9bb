"""ZeRO stages 1 and 3 across processes (parallel/zero.py, the optimizer's
shards, trainer.py's step, the sharded saves and the commit barrier of
utils/checkpoint.py and asyncplane/committer.py), on gloo CPU ranks of
``tests/torch_zero_worker.py``.

* resnet18 (SGD Nesterov, BN ghost groups of 4) and gpt_nano (AdamW) at
  dp2, f64, two and three steps: stages 1 and 3, and stage 3 under every
  gather schedule (``ZERO.GATHER_AHEAD`` -1, 0, 1) and ``ZERO.OVERLAP``
  either way, give the stage-0 run's losses, parameters, moments and eval
  sums bit for bit (a sum of two ranks' gradients is the same number in
  either order); each step's data-axis all-gathers are within JAX's
  ``collective_expectations`` bound (stage 1: 2 a split leaf; stage 3
  gather-once: a leaf + 4; per-use: 10 a leaf); each rank's resting bytes
  equal the layout's prediction; the moments are shard-sized.
* The resnet18 run against JAX's ``make_train_step`` at the global batch
  on one device: losses to 1e-7 relative, every parameter and running
  stat to 1e-7 of its tensor's largest magnitude (the DDP tolerances of
  ``PERF.md`` §2).
* gpt_nano at dp2·tp2·zero3 on four ranks: the dp2·tp2 stage-0 bits.
* ``train_model`` at stage 3 with ``CHECKPOINT.ASYNC``: a sharded
  directory in JAX's layout that JAX's ``read_sharded_checkpoint`` reads,
  equal tensor for tensor to the stage-0 run's synchronous ``.pth``; one
  process resumes it, and two ranks at stage 1 resume it bit for bit as
  two ranks at stage 0 resume the ``.pth``.
* The drills, as JAX's: the primary killed at the shard barrier or at the
  commit barrier leaves a manifest-less save the restart walks back over;
  a dropped shard file fails the digest walk and a direct load refuses,
  naming the recorded sharding; ``ASYNC.BARRIER_TIMEOUT_S`` bounds a
  barrier wait with an ``AsyncCommitError``.
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    ZERO_WORKER,
    Ranks,
    compare_with_jax,
    few_threads,
    jax_resnet,
    random_variables,
    reset_port_cfg,
    stream_batch,
)

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.asyncplane import committer as jcommitter
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import config as tconfig
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.asyncplane import committer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.dummy import DummyDataset
from distribuuuu_tpu_torch.resilience import manifest
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET = os.path.join(REPO, "config", "resnet18.yaml")
GPT = os.path.join(REPO, "config", "gpt_nano.yaml")
LR, STEPS, SEQ = 0.05, 2, 16
BASE = ["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float64", "MESH.DATA", 2,
        "OPTIM.BASE_LR", LR]
RESNET_OPTS = [*BASE, "MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", 32, "TRAIN.BATCH_SIZE", 4]
GPT_OPTS = [*BASE, "LM.SEQ_LEN", SEQ, "TRAIN.BATCH_SIZE", 2, "MODEL.NUM_CLASSES", 320]
# (name, stanza overrides) of the two-rank lockstep runs; an arm is held
# against "s0", or "s0_accum" under gradient accumulation
ARMS = {
    "resnet18": [("s0", ["MESH.ZERO", 0]), ("s1", ["MESH.ZERO", 1]),
                 ("s3", ["MESH.ZERO", 3, "ZERO.OVERLAP", False]),
                 ("s3_per_use", ["MESH.ZERO", 3, "ZERO.GATHER_AHEAD", 0]),
                 ("s3_ahead1", ["MESH.ZERO", 3, "ZERO.GATHER_AHEAD", 1,
                                "ZERO.OVERLAP", False]),
                 ("s0_accum", ["MESH.ZERO", 0, "TRAIN.GRAD_ACCUM_STEPS", 2]),
                 ("s3_accum", ["MESH.ZERO", 3, "TRAIN.GRAD_ACCUM_STEPS", 2])],
    "gpt_nano": [("s0", ["MESH.ZERO", 0]), ("s3", ["MESH.ZERO", 3]),
                 ("s3_per_use", ["MESH.ZERO", 3, "ZERO.GATHER_AHEAD", 0,
                                 "ZERO.OVERLAP", False])],
}
TRAIN_OPTS = ["MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", 32, "TEST.IM_SIZE", 32,
              "TRAIN.BATCH_SIZE", 2, "TEST.BATCH_SIZE", 4, "MODEL.DUMMY_INPUT", True,
              "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
              "TRAIN.WORKERS", 0, "OPTIM.BASE_LR", 0.01, "RNG_SEED", 0,
              "ASYNC.BARRIER_TIMEOUT_S", 20.0]
DUMMY = 8


def _train(out: str, epochs: int, *opts) -> list:
    return [*TRAIN_OPTS, "OUT_DIR", out, "OPTIM.MAX_EPOCH", epochs, *opts]


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _jax_steps(weights):
    """JAX's steps on one device at the global batch of 8, f64, ghost BN
    groups of 4: the losses and the (params, batch_stats) after them."""
    jmodel = jmodels.build_model("resnet18", num_classes=10, dtype=jnp.float64, bn_group=4)
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


def _in_process_train(opts: list) -> list:
    """``train_model`` in this process on ``DUMMY`` dummy samples a split."""
    reset_port_cfg()
    tconfig.merge_from_file(RESNET)
    tcfg.merge_from_list(opts)
    dataset = tloader._build_dataset
    tloader._build_dataset = lambda train: DummyDataset(DUMMY, tcfg.TRAIN.IM_SIZE, raw_u8=True)
    records = []
    try:
        trainer.train_model(records)
    finally:
        tloader._build_dataset = dataset
        reset_port_cfg()
    return records


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch, started at once; JAX's steps computed meanwhile."""
    tmp = tmp_path_factory.mktemp("zero")
    _, shapes = jax_resnet("resnet18")
    weights = random_variables(shapes, seed=5)
    torch.save(state_dict_from_jax(weights["params"], weights["batch_stats"]), tmp / "rw.pt")
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in stream_batch(i).items()}
               for i in range(STEPS)]
    torch.save(batches, tmp / "rb.pt")
    reset_port_cfg()
    tconfig.merge_from_file(GPT)
    tcfg.merge_from_list([*GPT_OPTS, "MESH.DATA", 1])
    torch.save(trainer.build_model_from_cfg().state_dict(), tmp / "gw.pt")
    reset_port_cfg()
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, 320, (4, SEQ + 1)).astype(np.int32) for _ in range(3)]
    torch.save([{"image": torch.from_numpy(t[:, :-1]), "label": torch.from_numpy(t[:, 1:])}
                for t in toks], tmp / "gb.pt")

    def lockstep(arch, name, opts, yaml, base, w, b):
        return {"name": f"{arch}_{name}", "kind": "lockstep", "yaml": yaml,
                "opts": [*base, *opts], "weights": str(tmp / w), "batches": str(tmp / b)}

    launches = {
        "resnet18": Ranks(2, [lockstep("resnet18", n, o, RESNET, RESNET_OPTS, "rw.pt", "rb.pt")
                              for n, o in ARMS["resnet18"]], tmp, "resnet18", timeout=240,
                          worker=ZERO_WORKER),
        "gpt_nano": Ranks(2, [lockstep("gpt_nano", n, o, GPT, GPT_OPTS, "gw.pt", "gb.pt")
                              for n, o in ARMS["gpt_nano"]], tmp, "gpt_nano", timeout=240,
                          worker=ZERO_WORKER),
        "tp": Ranks(4, [lockstep("tp", n, ["MESH.MODEL", 2, *o], GPT, GPT_OPTS, "gw.pt", "gb.pt")
                        for n, o in (("s0", ["MESH.ZERO", 0]), ("s3", ["MESH.ZERO", 3]))],
                    tmp, "tp", timeout=240, worker=ZERO_WORKER),
    }
    jax.config.update("jax_enable_x64", True)
    jcfg.defrost()
    saved = jcfg.clone()
    try:
        jcfg.OPTIM.BASE_LR = LR
        out = {"jax": _jax_steps(weights)}
    finally:
        jax.config.update("jax_enable_x64", False)
        jcfg.merge_from_other_cfg(saved)
    for key, ranks in launches.items():
        out[key] = ranks.join()
    # the saves, the resumes and the drills
    z3, z0 = str(tmp / "z3"), str(tmp / "z0")
    train = Ranks(2, [
        {"name": "z3", "kind": "train_model", "yaml": RESNET, "dummy": DUMMY,
         "opts": _train(z3, 1, "MESH.ZERO", 3, "CHECKPOINT.ASYNC", True)},
        {"name": "z0", "kind": "train_model", "yaml": RESNET, "dummy": DUMMY,
         "opts": _train(z0, 1, "MESH.ZERO", 0)},
    ], tmp, "train", timeout=240, worker=ZERO_WORKER)
    drills = {name: Ranks(2, [{"name": name, "kind": "train_model", "yaml": RESNET,
                               "dummy": DUMMY, "opts": _train(str(tmp / name), epochs, *opts)}],
                          tmp, name, timeout=120, worker=ZERO_WORKER)
              for name, epochs, opts in (
                  ("kill_shard", 2, ["MESH.ZERO", 3, "CHECKPOINT.ASYNC", True,
                                     "FAULTS.ENABLED", True, "FAULTS.KILL_AT_SHARD_BARRIER", 1,
                                     "ASYNC.BARRIER_TIMEOUT_S", 5.0]),
                  ("kill_commit", 2, ["MESH.ZERO", 0, "CHECKPOINT.ASYNC", True,
                                      "FAULTS.ENABLED", True,
                                      "FAULTS.KILL_AT_COMMIT_BARRIER", 1,
                                      "ASYNC.BARRIER_TIMEOUT_S", 5.0]),
                  ("drop", 1, ["MESH.ZERO", 3, "CHECKPOINT.ASYNC", True, "FAULTS.ENABLED", True,
                               "FAULTS.DROP_SHARD_FILE", 0, "FAULTS.DROP_SHARD_HOST", 1]))}
    out["train"] = train.join()
    # the second epoch, resumed by two ranks: at stage 1 from the sharded
    # save, at stage 0 from the .pth
    for src in (z3, z0):
        shutil.copytree(src, f"{src}_resumed")
    resumed = Ranks(2, [
        {"name": "from_z3", "kind": "train_model", "yaml": RESNET, "dummy": DUMMY,
         "opts": _train(f"{z3}_resumed", 2, "MESH.ZERO", 1)},
        {"name": "from_z0", "kind": "train_model", "yaml": RESNET, "dummy": DUMMY,
         "opts": _train(f"{z0}_resumed", 2, "MESH.ZERO", 0)},
    ], tmp, "resumed", timeout=240, worker=ZERO_WORKER)
    out["drills"] = {name: r.join(check=name == "drop") for name, r in drills.items()}
    out["resumed"] = resumed.join()
    out["tmp"] = tmp
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _states_equal(a: dict, b: dict) -> int:
    n = 0
    for part in ("model", "opt"):
        x, y = a[part], b[part]
        if part == "opt":
            x = {f"{k}/{n_}": t for k in ("m", "v") if x[k] is not None for n_, t in x[k].items()}
            y = {f"{k}/{n_}": t for k in ("m", "v") if y[k] is not None for n_, t in y[k].items()}
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (part, k)
            n += 1
    return n


@pytest.mark.parametrize("arch,arm", [(a, n) for a, arms in ARMS.items()
                                      for n, _ in arms if not n.startswith("s0")])
def test_stages_and_schedules_are_stage_zero_bitwise(runs, arch, arm):
    ranks = runs[arch]
    s0 = f"{arch}_s0_accum" if arm.endswith("accum") else f"{arch}_s0"
    ref, got = ranks[0][s0], ranks[0][f"{arch}_{arm}"]
    assert got["losses"] == ref["losses"] and len(set(got["losses"])) == len(got["losses"])
    assert ranks[1][f"{arch}_{arm}"]["losses"] == got["losses"]
    assert _states_equal(got["state"], ref["state"]) > 50
    assert got["eval"] == ref["eval"]
    assert 0 < got["sharded"] < got["leaves"]
    for r in ranks:
        o = r[f"{arch}_{arm}"]
        assert all(0 < g <= o["bound"] for g in o["gathers"]), (o["gathers"], o["bound"])
        assert o["resting"] == [o["predicted"]] * len(o["resting"])
        assert o["resting"][0] < r[s0]["resting"][0] == r[s0]["predicted"]
        for name, z in o["zdims"].items():
            full = ref["moment_shapes"][name]
            want = full if z is None else full[:z] + (full[z] // 2,) + full[z + 1:]
            assert o["moment_shapes"][name] == want, name


def _one_process(weights: str, batches: list) -> tuple:
    """The port's one-process run at the global batch (ghost groups of 4),
    f64: losses and state dict."""
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    reset_port_cfg()
    tconfig.merge_from_file(RESNET)
    tcfg.merge_from_list([*RESNET_OPTS, "MESH.DATA", 1, "TRAIN.BATCH_SIZE", 8,
                          "MODEL.BN_GROUP", 4])
    model = trainer.build_model_from_cfg()
    model.load_state_dict(torch.load(weights, weights_only=True))
    model = model.to(torch.float64).train()
    opt = construct_optimizer(model)
    losses = [float(trainer.train_step(model, opt, b, 5)["loss"]) for b in batches]
    reset_port_cfg()
    return losses, model.state_dict()


def test_stage_three_matches_one_process_and_jax_at_the_global_batch(runs):
    """The dp2 stage-3 run against the port's one-process run and JAX's
    one-device run at the global batch (the DDP tolerances)."""
    want_losses, want = runs["jax"]
    tmp = runs["tmp"]
    batches = torch.load(tmp / "rb.pt", weights_only=True)
    one_losses, one = _one_process(str(tmp / "rw.pt"), batches)
    got = runs["resnet18"][0]["resnet18_s3"]["state"]["model"]
    for r in runs["resnet18"]:
        np.testing.assert_allclose(r["resnet18_s3"]["losses"], want_losses, rtol=1e-7)
        np.testing.assert_allclose(r["resnet18_s3"]["losses"], one_losses, rtol=1e-7)
    assert compare_with_jax(want, got, 1e-7) > 100
    for k, t in one.items():
        if t.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-7,
                                       atol=1e-7 * float(t.abs().max()), err_msg=k)


def test_dp2_tp2_zero3_on_four_ranks(runs):
    """gpt_nano's column-parallel Linears with the data axis composed on
    their split dim (``('model', 'data')``) or another: the dp2·tp2 stage-0
    bits on every rank."""
    for r in runs["tp"]:
        assert r["tp_s3"]["losses"] == r["tp_s0"]["losses"]
        assert r["tp_s3"]["resting"][-1] == r["tp_s3"]["predicted"] < r["tp_s0"]["resting"][-1]
    assert _states_equal(runs["tp"][0]["tp_s3"]["state"], runs["tp"][0]["tp_s0"]["state"]) > 50
    z = runs["tp"][0]["tp_s3"]["zdims"]
    assert z["blocks.0.attn.qkv.weight"] is not None  # composed with the model split


def test_sharded_async_save_reads_in_jax_and_resumes(runs):
    tmp = runs["tmp"]
    z3 = os.path.join(tmp, "z3", "checkpoints", "ckpt_ep_000")
    pth = os.path.join(tmp, "z0", "checkpoints", "ckpt_ep_000.pth")
    assert sorted(os.listdir(z3)) == ["MANIFEST.json", "SHARDS_host0.json", "SHARDS_host1.json",
                                      "shards_host0.npz", "shards_host1.npz"]
    assert manifest.verify_checkpoint(z3) == (True, "ok")
    assert manifest.read_manifest(z3)["sharded"]["hosts"] == 2
    assert [r["z3"]["losses"] for r in runs["train"]] == [r["z0"]["losses"] for r in runs["train"]]
    sharded, full = ckpt.load_checkpoint(z3), ckpt.load_checkpoint(pth)
    assert _states_equal(sharded, full) > 100
    assert (sharded["step"], sharded["epoch"], sharded["opt"]["count"]) == \
        (full["step"], full["epoch"], full["opt"]["count"])
    # the JAX package's reader: params and batch_stats under JAX's paths
    tree = jcommitter.read_sharded_checkpoint(z3)
    want = jax_tree_from_state_dict(full["model"])
    for part in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(want[part])[0]
        assert len(flat) >= 40
        for path, leaf in flat:
            node = tree[part]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, leaf)
    # two ranks at stage 1 from the sharded save = two at stage 0 from the .pth
    a, b = runs["resumed"][0]["from_z3"], runs["resumed"][0]["from_z0"]
    assert a["epochs"] == b["epochs"] == [1] and a["losses"] == b["losses"]
    # one process resumes the sharded save
    one = os.path.join(tmp, "one")
    shutil.copytree(os.path.join(tmp, "z3"), one)
    recs = _in_process_train(_train(one, 2, "MODEL.BN_GROUP", 4, "TRAIN.BATCH_SIZE", 4))
    assert [r["epoch"] for r in recs] == [1]
    assert np.isfinite(recs[0]["losses"]).all()


@pytest.mark.parametrize("name", ["kill_shard", "kill_commit"])
def test_primary_killed_at_the_barrier_walks_back(runs, name):
    """The primary dies between every process's durable share and the
    manifest of epoch 1's save; the peer's wait ends (its barrier wait or
    the group's collectives fail); the restart quarantines the
    manifest-less save and resumes epoch 1 from epoch 0's."""
    tmp = runs["tmp"]
    (rc0, log0), (rc1, _) = runs["drills"][name]
    assert rc0 == -9, log0[-2000:]
    assert rc1 != 0
    ckdir = os.path.join(tmp, name, "checkpoints")
    broken = "ckpt_ep_001" if name == "kill_shard" else "ckpt_ep_001.pth"
    assert manifest.verify_checkpoint(os.path.join(ckdir, broken))[0] is False
    if name == "kill_shard":  # every shard file durable, the manifest never written
        assert {"shards_host0.npz", "shards_host1.npz"} <= set(
            os.listdir(os.path.join(ckdir, broken)))
    recs = _in_process_train(_train(os.path.join(tmp, name), 2, "MODEL.BN_GROUP", 4,
                                    "TRAIN.BATCH_SIZE", 4))
    assert [r["epoch"] for r in recs] == [1]
    assert os.path.exists(os.path.join(ckdir, broken + ".corrupt"))


def test_dropped_shard_file_fails_the_digest_walk_and_a_direct_load(runs):
    tmp = runs["tmp"]
    path = os.path.join(tmp, "drop", "checkpoints", "ckpt_ep_000")
    assert not os.path.exists(os.path.join(path, "shards_host1.npz"))
    ok, reason = manifest.verify_checkpoint(path)
    assert not ok and reason == "payload file missing: shards_host1.npz"
    with pytest.raises(ckpt.CheckpointError, match="records hosts=2"):
        ckpt.load_checkpoint(path)
    with pytest.raises(jcommitter.ShardLayoutError, match="records hosts=2"):
        jcommitter.read_sharded_checkpoint(path)
    reset_port_cfg()
    tcfg.merge_from_list(["OUT_DIR", os.path.join(tmp, "drop")])
    try:
        with pytest.raises(ckpt.NoValidCheckpointError):
            ckpt.find_last_valid_checkpoint()
    finally:
        reset_port_cfg()
    assert os.path.isdir(path + ".corrupt")


def test_barrier_wait_is_bounded(tmp_path):
    """A peer whose primary never opens the barrier gives up after
    ``ASYNC.BARRIER_TIMEOUT_S``: the commit fails and the next join raises
    ``AsyncCommitError``, as JAX's does."""
    reset_port_cfg()
    tcfg.merge_from_list(["ASYNC.BARRIER_TIMEOUT_S", 0.3])
    path = str(tmp_path / "ckpt_ep_000")
    try:
        committer.submit_commit("ckpt_ep_000", lambda: committer.multihost_commit(
            path, 0, None, manifest.manifest_path(path), 1, 2))
        with pytest.raises(committer.AsyncCommitError,
                           match=r"cross-host barrier open \(ckpt_ep_000\): no progress"):
            committer.join_commits()
    finally:
        reset_port_cfg()
