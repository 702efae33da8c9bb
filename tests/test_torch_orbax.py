"""Orbax checkpoints read without JAX (distribuuuu_tpu_torch/utils/orbax.py)
and loaded through ``MODEL.WEIGHTS`` (utils/weights.load_weights).

The JAX package writes every checkpoint here in ``tmp_path`` (its
weights-only best side-write, its full ``save_checkpoint``, orbax's own
``PyTreeCheckpointer`` for bf16 leaves, scalars, strings and an array
sharded over the 8 CPU devices, its sharded ``SHARDS_host*`` layout) and
its ``load_checkpoint`` is the oracle: the reader's trees must equal it
bitwise (bf16 widened to f32). Models loaded from a directory must equal
models loaded through ``state_dict_from_jax``, and their f32 forward JAX's
within LOGIT_TOL of the logit scale."""

from __future__ import annotations

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from make_orbax_toy import DEFAULT_OUT, _save, images_f32, make
from torch_port_util import (
    TOY_REGNET,
    few_threads,
    jax_gpt,
    jax_regnet,
    jax_resnet,
    port_gpt,
    port_regnet,
    random_variables,
    reset_port_cfg,
)

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.asyncplane import committer as jcommitter
from distribuuuu_tpu.utils import checkpoint as jckpt
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.utils import orbax, weights, zstd

LOGIT_TOL = 1e-5  # f32: max |port - JAX| over max |JAX| logit
FIXTURE_TOL = 1e-3  # the committed fixture's logits, as the chip run holds them


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads(2)


def _assert_same(mine, ref, path="") -> None:
    """``mine`` equals ``ref`` (a tree of JAX's load_checkpoint) leaf for
    leaf, bitwise, a bf16 leaf of ``ref`` widened to f32."""
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref), (path, sorted(mine))
        for k in ref:
            _assert_same(mine[k], ref[k], f"{path}/{k}")
        return
    if isinstance(ref, str):
        assert mine == ref, path
        return
    r = np.asarray(ref)
    if r.dtype == jnp.bfloat16:
        r = r.astype(np.float32)
    m = np.asarray(mine)
    assert (m.dtype, m.shape) == (r.dtype, r.shape), path
    assert m.tobytes() == r.tobytes(), path


@pytest.fixture(scope="module")
def regnet():
    jmodel, shapes = jax_regnet(num_classes=10)
    return jmodel, random_variables(shapes, seed=7)


@pytest.fixture(scope="module")
def saved(regnet, tmp_path_factory):
    """The JAX package's best side-write and full save of the toy RegNet."""
    out = str(tmp_path_factory.mktemp("saved"))
    _, v = regnet
    _save(lambda ck: ck._write_best(v["params"], v["batch_stats"], 0), out, "best")
    from distribuuuu_tpu import trainer as jtrainer
    from distribuuuu_tpu.parallel.partition.lowering import TrainState
    from distribuuuu_tpu.utils.optim import construct_optimizer

    opt = construct_optimizer()
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.01), v["params"])
    _, opt_state = jax.jit(opt.update)(grads, opt.init(v["params"]), v["params"])  # a trace off 0
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"], opt_state=opt_state,
                       step=jnp.int32(3), key=jax.random.key(0))

    def full(ck):
        ck.save_checkpoint(jtrainer._state_tree(state), 2, 41.5, False)
        return ck.get_checkpoint(2)

    _save(full, out, "full")
    return out


@pytest.mark.parametrize("kind", ["best", "full"])
def test_reader_equals_load_checkpoint(saved, kind):
    path = os.path.join(saved, kind)
    _assert_same(orbax.read_checkpoint(path), jckpt.load_checkpoint(path))
    if kind == "full":  # MODEL.WEIGHTS decodes params and batch_stats only
        got = orbax.read_checkpoint(path, keys=orbax.WEIGHT_KEYS)
        assert set(got) == {"params", "batch_stats"}


def test_reader_dtypes_scalars_strings_and_chunks(tmp_path):
    """bf16, f64, int and uint8 leaves, numpy and Python scalars, a string,
    and an array sharded over the 8 CPU devices (one zarr chunk a shard)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("d",))
    sharded = jax.device_put(jnp.arange(16 * 6, dtype=jnp.float32).reshape(16, 6) * 0.37,
                             jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("d")))
    rng = np.random.default_rng(0)
    tree = {
        "bf16": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
        "f64": rng.standard_normal(4),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "i64": np.array([1 << 40, -3], np.int64),
        "u8": rng.integers(0, 256, 7).astype(np.uint8),
        "s": {"np": np.float32(2.5), "py_int": 5, "py_float": 1.25, "name": "optax_leaves_v1"},
        "sharded": sharded,
    }
    path = str(tmp_path / "ck")
    ocp.PyTreeCheckpointer().save(path, tree, force=True)
    got = orbax.read_checkpoint(path)
    _assert_same(got, ocp.PyTreeCheckpointer().restore(path))
    store = orbax.OcdbtStore(path)
    import json

    assert json.loads(store.get("sharded/.zarray"))["chunks"] == [2, 6]
    assert sum(k.startswith("sharded/") and not k.endswith(".zarray") for k in store.keys()) == 8


def test_reader_reads_the_sharded_layout(tmp_path, regnet):
    """The cross-host async save's files, written by the JAX package for
    one host; a layout naming two hosts with one host's files is refused."""
    _, v = regnet
    tree = {"params": v["params"], "batch_stats": v["batch_stats"], "epoch": np.int32(4)}
    path = str(tmp_path / "sharded")
    owned, layout = jcommitter.snapshot_host_shards(tree, 0)
    jcommitter.write_host_shards(path, 0, 1, owned, layout)
    _assert_same(orbax.read_checkpoint(path), jckpt.load_checkpoint(path))
    model = port_regnet(regnet[0], v)
    dst = _toy_regnet_port()
    weights.load_weights(dst, path)
    for k, t in model.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    two = str(tmp_path / "two")
    jcommitter.write_host_shards(two, 0, 2, owned, layout)
    with pytest.raises(orbax.OrbaxFormatError, match="hosts=2"):
        orbax.read_checkpoint(two)
    with pytest.raises(jcommitter.ShardLayoutError):
        jcommitter.read_sharded_checkpoint(two)


def _toy_regnet_port(se_ratio: float = 0.25, num_classes: int = 10):
    from distribuuuu_tpu_torch.models.regnet import _regnet

    return _regnet(num_classes, **TOY_REGNET, se_ratio=se_ratio, dtype=torch.float32).eval()


@pytest.mark.parametrize("kind", ["best", "full"])
def test_model_weights_dir_equals_state_dict_from_jax(saved, regnet, kind):
    jmodel, v = regnet
    want = port_regnet(jmodel, v)
    model = weights.load_weights(_toy_regnet_port(), os.path.join(saved, kind))
    for k, t in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], t), k
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - ref)) <= LOGIT_TOL * np.max(np.abs(ref))


def test_load_stays_strict(saved):
    """A JAX leaf with no port tensor raises, and so does a port tensor no
    leaf fills: a RegNetY's tree into a RegNetX, and the reverse."""
    with pytest.raises(RuntimeError, match="Unexpected key"):
        weights.load_weights(_toy_regnet_port(se_ratio=0.0), os.path.join(saved, "best"))
    _, shapes = jax_regnet(se_ratio=0.0, num_classes=10)
    v = random_variables(shapes)
    out = os.path.dirname(os.path.join(saved, "x"))
    _save(lambda ck: ck._write_best(v["params"], v["batch_stats"], 0), out, "x_best")
    with pytest.raises(RuntimeError, match="Missing key"):
        weights.load_weights(_toy_regnet_port(), os.path.join(out, "x_best"))


def test_refusals(tmp_path, saved, monkeypatch):
    with pytest.raises(orbax.OrbaxFormatError, match="not a directory"):
        orbax.read_checkpoint(str(tmp_path / "missing"))
    with pytest.raises(orbax.OrbaxFormatError, match="no _METADATA"):
        weights.load_weights(build_model("resnet18", num_classes=10), str(tmp_path))
    bad = str(tmp_path / "bad")
    shutil.copytree(os.path.join(saved, "best"), bad)
    with open(os.path.join(bad, "manifest.ocdbt"), "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(orbax.OrbaxFormatError, match="CRC-32C"):
        orbax.read_checkpoint(bad)
    gone = str(tmp_path / "gone")
    shutil.copytree(os.path.join(saved, "best"), gone)
    shutil.rmtree(os.path.join(gone, "ocdbt.process_0"))
    with pytest.raises(OSError):
        orbax.read_checkpoint(gone)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd_missing.so.9")
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(OSError, match="libzstd_missing.so.9"):
        orbax.read_checkpoint(os.path.join(saved, "best"))


def test_fixture_forward_and_greedy_tokens():
    """The committed fixture (tests/data/orbax_toy/, as the chip run reads
    it): the port's f32 logits from cnn_best and cnn_full within
    FIXTURE_TOL of the JAX logits' scale, and the GPT's greedy tokens JAX's."""
    import json

    with open(os.path.join(DEFAULT_OUT, "meta.json")) as f:
        meta = json.load(f)
    want = np.load(os.path.join(DEFAULT_OUT, "cnn_logits.npy"))
    x = torch.from_numpy(images_f32(np.load(os.path.join(DEFAULT_OUT, "cnn_images.npy"))))
    for kind in ("cnn_best", "cnn_full"):
        model = weights.load_weights(
            _toy_regnet_port(meta["regnet"]["se_ratio"], meta["regnet"]["num_classes"]),
            os.path.join(DEFAULT_OUT, kind))
        with torch.no_grad():
            got = model(x).numpy()
        assert np.max(np.abs(got - want)) <= FIXTURE_TOL * np.max(np.abs(want)), kind
    from distribuuuu_tpu_torch.models.gpt import GPT

    g = meta["gpt"]
    gpt = weights.load_weights(GPT(**g, dtype=torch.float32), os.path.join(DEFAULT_OUT, "gpt_best"))
    seqs = torch.from_numpy(np.load(os.path.join(DEFAULT_OUT, "gpt_prompts.npy"))).long()
    with torch.no_grad():
        for _ in range(meta["new_tokens"]):
            seqs = torch.cat([seqs, gpt.eval()(seqs)[:, -1].argmax(-1, keepdim=True)], 1)
    np.testing.assert_array_equal(seqs[:, -meta["new_tokens"]:].numpy(),
                                  np.load(os.path.join(DEFAULT_OUT, "gpt_tokens.npy")))


def test_fixture_rebuilds_to_the_same_trees(tmp_path):
    """tests/make_orbax_toy.py run again writes the committed trees (file
    names are hashes: trees, not bytes, are compared) and outputs."""
    make(str(tmp_path))
    for name in ("cnn_best", "cnn_full", "gpt_best"):
        _assert_same(orbax.read_checkpoint(os.path.join(DEFAULT_OUT, name)),
                     orbax.read_checkpoint(str(tmp_path / name)))
    for name in ("cnn_images", "cnn_logits", "gpt_prompts", "gpt_tokens"):
        np.testing.assert_allclose(np.load(str(tmp_path / f"{name}.npy")),
                                   np.load(os.path.join(DEFAULT_OUT, f"{name}.npy")), rtol=1e-6)
    files = [os.path.join(r, f) for r, _, fs in os.walk(DEFAULT_OUT) for f in fs]
    assert sum(os.path.getsize(f) for f in files) < 512 * 1024


def test_resnet50_full_width_round_trip(tmp_path, capsys):
    """ResNet-50's full-width tree (25.6 M weights, 102 MB of f32) through
    the JAX best side-write and the reader, timed; the loaded model equals
    one loaded through ``state_dict_from_jax``."""
    _, shapes = jax_resnet("resnet50", num_classes=1000, im=224)
    v = random_variables(shapes, seed=2)
    _save(lambda ck: ck._write_best(v["params"], v["batch_stats"], 0), str(tmp_path), "r50")
    path = str(tmp_path / "r50")
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    tree = orbax.read_checkpoint(path, keys=orbax.WEIGHT_KEYS)
    read_s = time.perf_counter() - t0
    model = build_model("resnet50", num_classes=1000)
    weights.load_weights(model, path)
    want = weights.state_dict_from_jax(v["params"], v["batch_stats"])
    for k, t in want.items():
        assert torch.equal(model.state_dict()[k], t), k
    _assert_same(tree, {"params": v["params"], "batch_stats": v["batch_stats"]})
    with capsys.disabled():
        print(f"\nresnet50 orbax read: {size / 1e6:.1f} MB on disk in {read_s:.3f} s "
              f"({size / 1e6 / read_s:.0f} MB/s, one host core)")


def test_serving_and_eval_entry_points_take_a_directory(tmp_path):
    """``MODEL.WEIGHTS <dir>`` in the image engine, the GPT engine and its
    draft (``DRAFT_WEIGHTS``), and ``test_net``."""
    from distribuuuu_tpu_torch.lm import service as tservice
    from distribuuuu_tpu_torch.serve import engine_from_cfg

    gmodel, gshapes = jax_gpt(seq_len=32, vocab=320, dim=128, depth=4, heads=4)
    gv = random_variables(gshapes, seed=5)
    _save(lambda ck: ck._write_best(gv["params"], {}, 0), str(tmp_path), "gpt")
    gdir = str(tmp_path / "gpt")
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "LM.SEQ_LEN", 32, "GENERATE.PROMPT_LEN", 8,
                          "GENERATE.MAX_NEW_TOKENS", 4, "GENERATE.BATCH_TILES", [1],
                          "GENERATE.SPECULATE.ENABLED", True,
                          "GENERATE.SPECULATE.DRAFT_ARCH", "gpt_nano",
                          "GENERATE.SPECULATE.DRAFT_WEIGHTS", gdir,
                          "MODEL.WEIGHTS", gdir, "OUT_DIR", str(tmp_path / "lm")])
    eng = tservice.engine_from_cfg()
    want = port_gpt(gmodel, gv).state_dict()
    for m in (eng.model, eng.draft_model):
        for k, t in want.items():
            assert torch.equal(m.state_dict()[k].float(), t), k
    eng.drain()

    reset_port_cfg()
    _, shapes = jax_resnet("resnet18")
    v = random_variables(shapes, seed=6)
    _save(lambda ck: ck._write_best(v["params"], v["batch_stats"], 0), str(tmp_path), "r18")
    tconfig.merge_from_file("config/resnet18.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", 32,
                          "SERVE.BUCKET_SIZES", [1, 8], "MODEL.WEIGHTS", str(tmp_path / "r18"),
                          "OUT_DIR", str(tmp_path / "img")])
    eng = engine_from_cfg()
    want = weights.state_dict_from_jax(v["params"], v["batch_stats"])
    for k, t in want.items():
        assert torch.equal(eng.model.state_dict()[k].float(), t), k
    eng.drain()
    from distribuuuu_tpu_torch import trainer

    tcfg.merge_from_list(["MODEL.DUMMY_INPUT", True, "TRAIN.BATCH_SIZE", 1,  # 64 images
                          "TEST.BATCH_SIZE", 16, "TEST.IM_SIZE", 32, "TRAIN.WORKERS", 1])
    top1, _ = trainer.test_model()
    assert 0.0 <= top1 <= 100.0
