"""The port's shards format (``distribuuuu_tpu_torch/data/shards/``, the
loader's cursor, the native decoder's in-memory entry points) against the
JAX package's ``distribuuuu_tpu/data/shards/``, on the CPU at toy size.

The corpus is the JAX tests' (``tests/test_shards.py``): three classes of
40×50 JPEGs, 16 train and 4 val a class, packed at a 16 KiB target so a
split has several shards, here once by each package. What is held, each
exactly unless it says otherwise:

- the two packs: the same shard files byte for byte, manifests equal but
  for ``source``; each package reads the other's pack record for record;
  the port's ``verify_split`` passes it and names a flipped byte, a
  missing shard and a wrong size;
- the order: ``global_order`` over a grid of ``(n, seed, epoch, block,
  window)`` (``block=1, window=n`` among them), every rank's
  ``WindowShuffleSampler.indices()`` at world 1, 2 and 4 and
  ``order_state()``;
- the forward-scan recovery of a truncated shard: JAX's offsets and flag;
- decoded batches, uint8 and float32, through PIL and through the native
  in-memory path: JAX's ``ShardDataset``'s and the port's
  ``ImageFolderDataset``'s on the source tree;
- the cursor: ``Loader.state_dict`` JAX's as JSON, the refusals of
  ``load_state_dict``, the one-shot skip, the checkpoint encoding;
- the slice: the first two batches of each package's shard ``Loader`` are
  equal, and two f64 steps on them (JAX's ``make_train_step``, the port's
  ``train_step``, resnet18, 3 classes, 32²) agree within 1e-7 of each
  tensor's scale (parameters, momentum, running stats);
- the ``FAULTS.TRUNCATE_SHARD`` drill, the ``DATA.BACKEND native`` refusal
  and the packer's command line.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image
from torch_port_util import (
    compare_with_jax,
    few_threads,
    jax_resnet,
    jax_trace,
    random_variables,
    reset_port_cfg,
)

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.data import loader as jloader
from distribuuuu_tpu.data.shards import format as jformat
from distribuuuu_tpu.data.shards import order as jorder
from distribuuuu_tpu.data.shards.reader import ShardDataset as JShardDataset
from distribuuuu_tpu.parallel import sharding as jsharding
from distribuuuu_tpu.parallel.partition.lowering import TrainState
from distribuuuu_tpu.utils import faults as jfaults
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import native, trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data import loader as tloader
from distribuuuu_tpu_torch.data.imagefolder import ImageFolderDataset
from distribuuuu_tpu_torch.data.shards import format as tformat
from distribuuuu_tpu_torch.data.shards import order as torder
from distribuuuu_tpu_torch.data.shards.reader import ShardDataset
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 16 * 1024  # bytes a shard: several shards a split
BLOCK, WINDOW = 4, 16  # the order's knobs at toy size
STEP_TOL = 1e-7  # two f64 steps, port vs JAX: of each tensor's largest magnitude
NATIVE = pytest.mark.skipif(not native.available(),
                            reason=f"native decoder unavailable: {native.build_error()}")


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    faults.reset()
    jfaults.reset()
    saved = jcfg.clone()
    jcfg.defrost()
    yield
    jcfg.merge_from_other_cfg(saved)
    reset_port_cfg()
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX tests' tree, packed by each package."""
    root = tmp_path_factory.mktemp("torch_shards")
    src = root / "src"
    rng = np.random.default_rng(0)
    for split, per_cls in (("train", 16), ("val", 4)):
        for cls in ("class_a", "class_b", "class_c"):
            d = src / split / cls
            d.mkdir(parents=True)
            for i in range(per_cls):
                arr = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.jpg", quality=90)
    jformat.pack_imagefolder(str(src), str(root / "jax"), target_bytes=TARGET)
    tformat.pack_imagefolder(str(src), str(root / "port"), target_bytes=TARGET)
    return {"src": str(src), "jax": str(root / "jax"), "port": str(root / "port")}


# ------------------------------------------------------------------- packs
@pytest.mark.parametrize("split", ["train", "val"])
def test_both_packs_are_byte_identical(corpus, split):
    jdir, tdir = (os.path.join(corpus[k], split) for k in ("jax", "port"))
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    shards = [f for f in files if f.endswith(".drec")]
    assert len(shards) > 1 or split == "val"
    for f in shards:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f), shallow=False), f
    jman, tman = jformat.read_shard_manifest(jdir), tformat.read_shard_manifest(tdir)
    assert jman.pop("source") == tman.pop("source") == os.path.abspath(corpus["src"])
    assert jman == tman


@pytest.mark.parametrize("reader,pack", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_pack(corpus, reader, pack):
    cls = ShardDataset if reader == "port" else JShardDataset
    ds = cls(corpus[pack], "train", im_size=32, train=True, backend="pil")
    src = ImageFolderDataset(corpus["src"], "train", im_size=32, train=True, backend="pil")
    assert len(ds) == len(src) == 48 and ds.classes == src.classes
    for i in range(len(ds)):
        image_bytes, label, key = ds.record(i)
        path, want = src.samples[i]
        with open(path, "rb") as f:
            assert image_bytes == f.read()
        assert label == want
        assert key == os.path.relpath(path, os.path.join(corpus["src"], "train"))


def _damage(work: str, how: str) -> str:
    man = tformat.read_shard_manifest(work)
    victim = os.path.join(work, man["shards"][0]["file"])
    if how == "flip":
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(victim, "wb").write(bytes(data))
    elif how == "missing":
        os.remove(victim)
    else:  # a shard that grew
        with open(victim, "ab") as f:
            f.write(b"\0")
    return man["shards"][0]["file"]


@pytest.mark.parametrize("how,needle", [("flip", "sha256 mismatch"), ("missing", "missing"),
                                        ("size", "size")])
def test_verify_split_certifies_and_names_the_damage(corpus, tmp_path, how, needle):
    ok, problems = tformat.verify_split(os.path.join(corpus["jax"], "train"))
    assert ok, problems
    work = str(tmp_path / "train")
    shutil.copytree(os.path.join(corpus["port"], "train"), work)
    name = _damage(work, how)
    ok, problems = tformat.verify_split(work)
    assert not ok and any(name in p and needle in p for p in problems), problems
    assert jformat.verify_split(work) == (ok, problems)


# ------------------------------------------------------------------- order
@pytest.mark.parametrize("n,seed,epoch,block,window", [
    (100, 7, 3, 8, 16), (96, 11, 2, 8, 32), (1000, 0, 0, 64, 1024), (37, 5, 9, 1, 37),
    (48, 2**33 + 5, 1, 4, 16), (5, 0, 0, 1, 5), (64, 3, 4, 64, 1), (1, 0, 0, 64, 1024),
])
def test_global_order_is_jaxs(n, seed, epoch, block, window):
    got = torder.global_order(n, seed, epoch, block, window)
    assert got.dtype == np.int64 and sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(got, jorder.global_order(n, seed, epoch, block, window))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sampler_indices_and_order_state_are_jaxs(world):
    n, seed, epoch = 98, 11, 2  # 98 pads to a multiple of 4 by wrapping
    inter = []
    for r in range(world):
        t = torder.WindowShuffleSampler(n, world, r, seed=seed, block=8, window=32)
        j = jorder.WindowShuffleSampler(n, world, r, seed=seed, block=8, window=32)
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        np.testing.assert_array_equal(t.indices(), j.indices())
        assert len(t) == len(j) and t.order_state() == j.order_state()
        assert json.loads(json.dumps(t.order_state())) == t.order_state()
        inter.append(t.indices())
    padded = np.stack(inter, 1).reshape(-1)
    order = torder.global_order(n, seed, epoch, 8, 32)
    np.testing.assert_array_equal(padded[:n], order)  # every world strides one order


# ----------------------------------------------------------------- recovery
def _truncated_copy(corpus, tmp_path, which=-1) -> tuple[str, dict]:
    work = tmp_path / "trunc"
    shutil.copytree(os.path.join(corpus["port"], "train"), work / "train")
    man = tformat.read_shard_manifest(str(work / "train"))
    victim = work / "train" / man["shards"][which]["file"]
    with open(victim, "r+b") as f:
        f.truncate(victim.stat().st_size * 6 // 10)
    return str(work), man


def test_truncated_shard_index_recovers_as_jaxs(corpus, tmp_path):
    work, man = _truncated_copy(corpus, tmp_path)
    victim = os.path.join(work, "train", man["shards"][-1]["file"])
    offsets, recovered = tformat.read_shard_index(victim)
    assert recovered and 0 < len(offsets) < man["shards"][-1]["records"]
    assert (offsets, recovered) == jformat.read_shard_index(victim)
    intact = os.path.join(work, "train", man["shards"][0]["file"])
    assert tformat.read_shard_index(intact) == jformat.read_shard_index(intact)
    ds = ShardDataset(work, "train", im_size=16, train=True, backend="pil")
    assert len(ds) == man["num_records"]
    ds[0]
    with pytest.raises(tformat.ShardReadError, match="lost to truncation"):
        ds[len(ds) - 1]


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("backend", ["pil", pytest.param("native", marks=NATIVE)])
@pytest.mark.parametrize("raw_u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_batches_are_jaxs_and_the_image_folders(corpus, backend, raw_u8, train):
    split, im = ("train", 32) if train else ("val", 36)
    kw = dict(im_size=im, train=train, base_seed=3, crop_size=None if train else 32,
              backend=backend, raw_u8=raw_u8)
    port = ShardDataset(corpus["jax"], split, **kw)
    jax_ds = JShardDataset(corpus["port"], split, **kw)
    folder = ImageFolderDataset(corpus["src"], split, **kw)
    idxs = [0, 5, 7, 11] if not train else [0, 5, 17, 46, 23]
    for d in (port, jax_ds, folder):
        d.set_epoch_seed(2)
    got, labels = port.load_batch(idxs, n_threads=2)
    assert got.dtype == (np.uint8 if raw_u8 else np.float32)
    assert port._use_native() == (backend == "native")
    for other in (jax_ds, folder):
        want, want_labels = other.load_batch(idxs, n_threads=2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(port[idxs[1]][0], jax_ds[idxs[1]][0])
    assert port.records_read == len(idxs) + 1 and port.bytes_read > 0


def test_native_backend_without_the_in_memory_api_raises(corpus, monkeypatch):
    monkeypatch.setattr(native, "has_mem_api", lambda: False)
    ds = ShardDataset(corpus["port"], "train", im_size=16, train=True, backend="native")
    with pytest.raises(RuntimeError, match="in-memory entry points"):
        ds.load_batch([0])
    auto = ShardDataset(corpus["port"], "train", im_size=16, train=True, backend="auto")
    assert not auto._use_native() and auto.load_batch([0])[0].shape == (1, 16, 16, 3)


# ------------------------------------------------------------------- cursor
def _loaders(corpus, seed: int = 7, raw_u8: bool = True, im: int = 16, batch: int = 8):
    """The port's and JAX's shard Loaders over one pack, same knobs."""
    jcfg.DATA.SHARDS_BLOCK, jcfg.DATA.SHARDS_WINDOW = BLOCK, WINDOW
    tcfg.DATA.SHARDS_BLOCK, tcfg.DATA.SHARDS_WINDOW = BLOCK, WINDOW
    kw = dict(im_size=im, train=True, base_seed=0, backend="pil", raw_u8=raw_u8)
    port = tloader.Loader(ShardDataset(corpus["port"], "train", **kw), batch, shuffle=True,
                          drop_last=True, workers=2, seed=seed)
    jax_l = jloader.Loader(JShardDataset(corpus["port"], "train", **kw), batch, shuffle=True,
                           drop_last=True, workers=2, seed=seed)
    return port, jax_l


def test_loader_state_dict_is_jaxs(corpus):
    port, jax_l = _loaders(corpus)
    assert port.can_save_state() and jax_l.can_save_state()
    for loader in (port, jax_l):
        loader.set_epoch(3)
    sd = port.state_dict(4)
    assert sd["cursor"] == 4 * 8 and sd["epoch"] == 3 and sd["format"] == "shards"
    assert json.dumps(sd, sort_keys=True) == json.dumps(jax_l.state_dict(4), sort_keys=True)
    folder = tloader.Loader(ImageFolderDataset(corpus["src"], "train", 16, True), 8, True,
                            True, 1)
    assert not folder.can_save_state()


@pytest.mark.parametrize("field,value,match", [
    ("format", "imagefolder", "live pipeline"), ("num_records", 7, "corpus changed"),
    ("seed", 99, "order identity"),
])
def test_load_state_dict_refuses_drift(corpus, field, value, match):
    port, _ = _loaders(corpus)
    port.set_epoch(0)
    sd = json.loads(json.dumps(port.state_dict(1)))
    if field == "seed":
        sd["order"]["seed"] = value  # ≙ RNG_SEED changed between the runs
    else:
        sd[field] = value
    fresh, _ = _loaders(corpus)
    with pytest.raises(ValueError, match=match):
        fresh.load_state_dict(sd)
    assert fresh.resume_skip(0) == 0


def test_restored_cursor_skips_exactly_once(corpus):
    port, _ = _loaders(corpus)
    port.set_epoch(1)
    full = [b["label"].tolist() for b in port]
    fresh, _ = _loaders(corpus)
    assert fresh.load_state_dict(json.loads(json.dumps(port.state_dict(2)))) == 2
    assert fresh.resume_skip(1) == 2 and fresh.resume_skip(0) == 0
    fresh.set_epoch(1)
    assert [b["label"].tolist() for b in fresh] == full[2:]
    fresh.set_epoch(2)
    assert len(list(fresh)) == len(fresh)  # one-shot: the next epoch is whole


def test_data_state_encoding_round_trips_and_survives_weights_only(tmp_path):
    sd = {"v": 1, "format": "shards", "epoch": 3, "cursor": 1024,
          "order": {"seed": 5, "rng_state": {"state": {"state": 2**100, "inc": 3}}}}
    t = ckpt.encode_data_state(sd)
    assert t.dtype == torch.uint8 and t.dim() == 1
    assert ckpt.decode_data_state(t) == sd == ckpt.decode_data_state(t.numpy())
    assert ckpt.decode_data_state(torch.zeros(4, dtype=torch.uint8)) is None
    torch.save({"data_state": t}, tmp_path / "p.pth")
    loaded = torch.load(tmp_path / "p.pth", weights_only=True)["data_state"]
    assert ckpt.decode_data_state(loaded) == sd


# ------------------------------------------------------------ the slice
def test_two_f64_steps_on_shard_batches_match_jax(corpus):
    """The first two batches of each package's shard Loader are equal;
    two f64 steps on them agree with JAX's."""
    port, jax_l = _loaders(corpus, raw_u8=False, im=32)
    for loader in (port, jax_l):
        loader.set_epoch(1)
    batches = []
    for tb, jb in zip(port, jax_l):
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(tb[k], jb[k])
        batches.append({"image": tb["image"].astype(np.float64), "label": tb["label"],
                        "mask": tb["mask"].astype(np.float64)})
        if len(batches) == 2:
            break
    _, shapes = jax_resnet("resnet18", num_classes=3)
    weights = random_variables(shapes, seed=7)
    lr, group = 0.05, 4

    jax.config.update("jax_enable_x64", True)
    try:
        jcfg.OPTIM.BASE_LR = lr
        jmodel = jmodels.build_model("resnet18", num_classes=3, dtype=jnp.float64,
                                     bn_group=group)
        cast = jax.tree.map(lambda a: jnp.asarray(a, np.float64), weights)
        opt = jax_construct_optimizer()
        state = TrainState(params=cast["params"], batch_stats=cast["batch_stats"],
                           opt_state=opt.init(cast["params"]), step=jnp.int32(0),
                           key=jax.random.key(0))
        step = jtrainer.make_train_step(jmodel, opt, topk=3)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        want_losses = []
        for b in batches:
            state, m = step(state, jsharding.shard_batch(mesh, b))
            want_losses.append(float(m["loss"]))
        want = jax.tree.map(np.asarray, (state.params, state.batch_stats,
                                         jax_trace(state.opt_state)))
    finally:
        jax.config.update("jax_enable_x64", False)

    tcfg.OPTIM.BASE_LR = lr
    model = tmodels.build_model("resnet18", num_classes=3, dtype=torch.float64,
                                bn_group=group)
    model.load_state_dict(state_dict_from_jax(weights["params"], weights["batch_stats"]))
    model = model.to(torch.float64).train()
    opt = construct_optimizer(model)
    got_losses = [float(trainer.train_step(model, opt, {
        "image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"])}, 3)["loss"])
        for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEP_TOL)
    params, stats, trace = want
    assert compare_with_jax((params, stats), model.state_dict(), STEP_TOL) > 100
    assert compare_with_jax((trace,), dict(zip(opt.names, opt.m)), STEP_TOL) == len(opt.names)


# ------------------------------------------------------------ truncation
def _shards_cfg(root: str, out_dir: str, *opts):
    tcfg.merge_from_list([
        "MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 3, "DEVICE.PLATFORM", "cpu",
        "DEVICE.COMPUTE_DTYPE", "float32", "DATA.FORMAT", "shards", "TRAIN.DATASET", root,
        "TEST.DATASET", root, "TRAIN.IM_SIZE", 16, "TEST.IM_SIZE", 18, "TRAIN.BATCH_SIZE", 8,
        "TEST.BATCH_SIZE", 12, "TRAIN.PRINT_FREQ", 2, "TRAIN.WORKERS", 1, "RNG_SEED", 1,
        "DATA.SHARDS_BLOCK", BLOCK, "DATA.SHARDS_WINDOW", WINDOW, "DATA.RETRIES", 0,
        "OPTIM.MAX_EPOCH", 1, "OUT_DIR", out_dir, *opts])


@pytest.mark.parametrize("skip_corrupt", [True, False])
def test_truncate_shard_drill(corpus, tmp_path, skip_corrupt):
    """``FAULTS.TRUNCATE_SHARD`` through ``train_model``: the last train
    shard loses its footer and tail; the reader recovers its index by
    forward scan (logged with the counts) and the lost records are
    substituted under ``DATA.SKIP_CORRUPT``, the epoch finishing; without
    it the run fail-stops."""
    import logging

    from distribuuuu_tpu_torch.utils.logger import get_logger

    work = tmp_path / "pack"
    shutil.copytree(corpus["port"], work)
    man = tformat.read_shard_manifest(str(work / "train"))
    last = len(man["shards"]) - 1
    _shards_cfg(str(work), str(tmp_path / "out"), "FAULTS.ENABLED", True,
                "FAULTS.TRUNCATE_SHARD", last, "DATA.SKIP_CORRUPT", skip_corrupt)
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    get_logger().addHandler(handler)
    records = []
    try:
        if skip_corrupt:
            trainer.train_model(records)
        else:
            with pytest.raises(RuntimeError, match="fail-stop"):
                trainer.train_model(records)
    finally:
        get_logger().removeHandler(handler)
    victim = work / "train" / man["shards"][last]["file"]
    assert victim.stat().st_size == man["shards"][last]["size"] * 6 // 10
    recovered = tformat.read_shard_index(str(victim))[0]
    want = (f"recovered {len(recovered)} of {man['shards'][last]['records']} records by "
            "forward scan")
    assert any(want in m for m in messages), messages
    if skip_corrupt:
        assert records[0]["steps"] == 6 and records[0]["eval_images"] == 12
        assert any("corrupt sample" in m and "substituting" in m for m in messages)


def test_check_train_cfg_takes_shards_and_the_truncate_knob():
    tcfg.merge_from_list(["DATA.FORMAT", "shards", "FAULTS.ENABLED", True,
                          "FAULTS.TRUNCATE_SHARD", 0, "DEVICE.PLATFORM", "cpu"])
    trainer.check_train_cfg()
    tcfg.DATA.FORMAT = "lmdb"
    with pytest.raises(ValueError, match="imagefolder\\|shards\\|tokens"):
        trainer.check_train_cfg()
    with pytest.raises(ValueError, match="imagefolder\\|shards\\|tokens"):
        tloader.construct_train_loader()


def test_packer_command_line_packs_and_verifies(corpus, tmp_path):
    out = tmp_path / "cli"

    def run(*args):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        return subprocess.run([sys.executable, "-m", "distribuuuu_tpu_torch.data.shards.pack",
                               *args], capture_output=True, text=True, cwd=REPO, env=env,
                              timeout=120)

    r = run("--src", corpus["src"], "--out", str(out), "--shard-mb", "0.015625")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert [x["split"] for x in lines] == ["train", "val"] and lines[0]["records"] == 48
    for split in ("train", "val"):  # the 16 KiB target: JAX's pack, byte for byte
        for f in os.listdir(out / split):
            if f.endswith(".drec"):
                assert filecmp.cmp(out / split / f, os.path.join(corpus["jax"], split, f),
                                   shallow=False)
    r = run("--out", str(out), "--verify")
    assert r.returncode == 0, r.stdout + r.stderr
    assert all(json.loads(x)["ok"] for x in r.stdout.splitlines() if x.startswith("{"))
    _damage(str(out / "val"), "flip")
    r = run("--out", str(out), "--verify", "--splits", "val")
    assert r.returncode == 1 and "VERIFY FAILED" in r.stdout
    assert run("--out", str(out)).returncode == 2  # packing needs --src
