"""``config/gpt_nano_moe.yaml``'s own MESH stanza (``DATA -1, MODEL 2,
EXPERT 2``) on 8 gloo CPU ranks, ``dp2·tp2·ep2``, at ``LM.SEQ_LEN 16`` and
batch 1 a process (the run ``tests/test_mesh_stanzas.py`` trains), and
``vit_tiny_moe`` at ``MESH.MODEL 2`` (its experts on the model axis, the
legacy layout), against the port's unsharded run and the JAX package's;
the shard layout against JAX's declared ``state_layout``; a sharded save
resumed by one process; and the topology registry against JAX's.

Tolerances. A sharded run and the port's unsharded run at f64 compute the
same sums in the forward (the column-parallel Linears are bit for bit the
unsharded ones) and differ in the backward's order of summation only
(every expert rank runs the f32 router on the whole gradient of its
weights, so the router computes the same bits), and in the balancing
statistics, f32 means of each data shard: their losses agree to 1e-9
relative over 3 steps (1e-7 over ``train_model``'s 20 steps an epoch),
and their states, where AdamW's normalised steps amplify the last ulps,
to 1e-6 of each tensor's scale. Against the JAX package, the
f32 router and attention scores of both (``test_torch_moe_models.py``)
bound the agreement to 1e-6 relative.
"""

from __future__ import annotations

import itertools
import os
import shutil
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import Ranks, assemble, few_threads, random_variables, reset_port_cfg

from distribuuuu_tpu import config as jconfig
from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel import mesh as jmesh
from distribuuuu_tpu.parallel.partition import specs as jspecs
from distribuuuu_tpu.parallel.partition import topology as jtopo
from distribuuuu_tpu.parallel.partition.lowering import TrainState, make_train_step
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import config as tconfig
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data.shards import tokens as ttok
from distribuuuu_tpu_torch.parallel import mesh as tmesh
from distribuuuu_tpu_torch.parallel.partition import specs as tspecs
from distribuuuu_tpu_torch.parallel.partition import topology as ttopo
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import jax_path_map, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_YAML = os.path.join(REPO, "config", "gpt_nano_moe.yaml")
VIT_YAML = os.path.join(REPO, "config", "vit_tiny_moe.yaml")
SEQ, STEPS = 16, 3
SHARDED_LOSS, SHARDED_STATE, JAX_REL = 1e-9, 1e-6, 1e-6  # module docstring
RUN_LOSS = 1e-7  # over train_model's 20 steps an epoch (module docstring)
GPT_OPTS = ["LM.SEQ_LEN", SEQ, "TRAIN.BATCH_SIZE", 1, "DEVICE.PLATFORM", "cpu",
            "DEVICE.COMPUTE_DTYPE", "float64", "RNG_SEED", 1]
VIT_OPTS = ["MESH.MODEL", 2, "TRAIN.IM_SIZE", 32, "MODEL.NUM_CLASSES", 10,
            "TRAIN.BATCH_SIZE", 2, "DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float64",
            "OPTIM.BASE_LR", 0.01]


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield from few_threads()
    reset_port_cfg()
    tmesh.reset()


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_variables(arch: str, **kw):
    jm = jmodels.build_model(arch, **kw)
    dummy = (jnp.zeros((2, 8), jnp.int32) if arch.startswith("gpt")
             else jnp.zeros((1, 32, 32, 3), jnp.float32))
    shapes = nn.unbox(jax.eval_shape(lambda k: jm.init(k, dummy, train=False),
                                     jax.random.key(0)))
    return jm, random_variables(shapes["params"], seed=11)


def _gpt_batches(n: int = 2) -> list:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 320, (n, SEQ + 1)).astype(np.int32)
        out.append({"image": torch.from_numpy(toks[:, :-1]),
                    "label": torch.from_numpy(toks[:, 1:])})
    return out


def _vit_batches(n: int = 2) -> list:
    rng = np.random.default_rng(8)
    return [{"image": torch.from_numpy(rng.standard_normal((n, 32, 32, 3))),
             "label": torch.from_numpy(rng.integers(0, 10, n).astype(np.int32))}
            for _ in range(2)]


def _unsharded(yaml: str, opts: list, sd: dict, batches: list):
    """The port in one process at f64 from ``sd`` over the whole batches:
    the losses, the first step's per-block aux and the state."""
    reset_port_cfg()
    tconfig.merge_from_file(yaml)
    tcfg.merge_from_list([*opts, "MESH.MODEL", 1, "MESH.EXPERT", 1])
    model = trainer.build_model_from_cfg()
    model.load_state_dict(sd)
    model = model.to(torch.float64).train()
    opt = construct_optimizer(model)
    losses, aux = [], None
    for b in batches:
        if aux is None:  # the step drops each layer's aux after its backward
            with torch.no_grad():
                model(trainer.prep_images(b["image"]))
            aux = [float(m.aux) for m in model.moe_layers()]
        losses.append(float(trainer.train_step(model, opt, b, 5)["loss"]))
    return losses, aux, model, opt


def _jax_losses(jm, variables, batches) -> list:
    jconfig.reset_cfg()
    jcfg.merge_from_file(GPT_YAML)
    opt = jax_construct_optimizer()
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    state = TrainState(params=params, batch_stats={}, opt_state=opt.init(params),
                       step=jnp.int32(0), key=jax.random.key(0))
    step = make_train_step(jm, opt, topk=5)
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        out.append(float(m["loss"]))
    jconfig.reset_cfg()
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pack(root) -> str:
    rng = np.random.default_rng(5)
    # 40 sequences of 16: no sampler padding at 2 data shards
    docs = [bytes(rng.integers(32, 120, (170,)).astype(np.uint8)) for _ in range(4)]
    ttok.write_token_shards(str(root / "train"), ttok.pack_token_stream(docs, SEQ), SEQ,
                            target_bytes=2048)
    return str(root)


def _run_opts(pack: str, out: str, epochs: int, batch: int = 1) -> list:
    """``train_model`` on the pack; one process takes ``batch`` 2, the
    global batch of the stanza's two data shards of 1."""
    return [*GPT_OPTS, "TRAIN.BATCH_SIZE", batch, "TRAIN.DATASET", pack, "TEST.DATASET", pack, "TEST.SPLIT", "train",
            "TEST.BATCH_SIZE", 4, "TRAIN.WORKERS", 1, "TRAIN.PRINT_FREQ", 4,
            "OPTIM.MAX_EPOCH", epochs, "DATA.SHARDS_BLOCK", 4, "DATA.SHARDS_WINDOW", 16,
            "OUT_DIR", out]


def _train_model_f64(opts: list) -> list:
    reset_port_cfg()
    tconfig.merge_from_file(GPT_YAML)
    tcfg.merge_from_list([*opts, "MESH.MODEL", 1, "MESH.EXPERT", 1])
    build = trainer.build_model_from_cfg
    trainer.build_model_from_cfg = lambda generator=None: build(generator).to(torch.float64)
    records = []
    try:
        trainer.train_model(records)
    finally:
        trainer.build_model_from_cfg = build
        tmesh.reset()
    return records


def _state_close(got: dict, want: dict, tol: float, steps: int = STEPS) -> None:
    """Tensor for tensor to ``tol`` of each tensor's scale, except the
    attention's key bias (the middle third of ``attn.qkv.bias``): its true
    gradient is 0 (softmax is invariant to it), so AdamW turns the f32
    scores' rounding noise into steps of up to the learning rate, other
    noise in each run; it is held to ``2 · lr · steps``."""
    assert set(got) == set(want)
    for k, v in want.items():
        if not (torch.is_tensor(v) and v.is_floating_point()):
            continue
        g = got[k]
        if k.endswith("attn.qkv.bias") and tcfg.OPTIM.OPTIMIZER == "adamw":
            d = v.shape[0] // 3
            key_bias = slice(d, 2 * d)
            assert float((g[key_bias] - v[key_bias]).abs().max()) <= (
                2 * tcfg.OPTIM.BASE_LR * steps), k
            g, v = torch.cat([g[:d], g[2 * d:]]), torch.cat([v[:d], v[2 * d:]])
        assert _rel(g, v) <= tol, (k, _rel(g, v))


def test_gpt_stanza_dp2_tp2_ep2_on_eight_ranks(tmp_path, x64):
    """The YAML's stanza on 8 ranks: three f64 steps in lockstep with the
    port's unsharded run and with JAX's; the balancing loss is the global
    batch's, not a mean of the data shards'; every rank holds the shard
    shapes JAX's ``state_layout`` declares; ``train_model`` on token shards
    saves full tensors equal to one process's save, and one process
    resumes that save for a second epoch as it resumes its own."""
    jm, variables = _jax_variables("gpt_nano_moe", num_classes=320, seq_len=SEQ,
                                   dtype=jnp.float64)
    sd = state_dict_from_jax(variables)
    torch.save(sd, tmp_path / "w.pt")
    batches = _gpt_batches()
    torch.save(batches, tmp_path / "b.pt")
    pack = _pack(tmp_path / "pack")
    ranks = Ranks(8, [
        {"name": "lockstep", "kind": "lockstep", "yaml": GPT_YAML, "opts": GPT_OPTS,
         "weights": str(tmp_path / "w.pt"), "batches": str(tmp_path / "b.pt")},
        {"name": "train", "kind": "train_model", "yaml": GPT_YAML,
         "opts": _run_opts(pack, str(tmp_path / "sharded"), 1)},
    ], tmp_path, "stanza", timeout=240)
    # meanwhile: the references
    want, want_aux, model, opt = _unsharded(GPT_YAML, GPT_OPTS, sd, batches)
    jax_losses = _jax_losses(jm, variables, batches)
    per_shard = []
    for d in range(2):
        _, aux, _, _ = _unsharded(GPT_YAML, GPT_OPTS, sd, [{k: v[d:d + 1] for k, v in
                                                            batches[0].items()}])
        per_shard.append(aux)
    layout = _jax_layout("gpt_nano_moe", [], GPT_YAML)
    ref_dir = str(tmp_path / "ref")
    ref1 = _train_model_f64(_run_opts(pack, ref_dir, 1, 2))[0]["losses"]
    joined = ranks.join()
    outs = [r["lockstep"] for r in joined]

    for o in outs:
        assert _rel(o["losses"], want) <= SHARDED_LOSS, (o["losses"], want)
        assert o["losses"] == outs[0]["losses"]
    assert _rel(outs[0]["losses"], jax_losses) <= JAX_REL
    # the global aux: E·Σ f·p over both data shards together
    assert _rel(outs[0]["aux"], want_aux) <= 1e-6
    mean_of_shards = np.mean(per_shard, axis=0)
    assert _rel(mean_of_shards, want_aux) > 1e-3
    full = outs[0]["state"]
    _state_close(full["model"], model.state_dict(), SHARDED_STATE)
    for key in ("m", "v"):
        _state_close(full["opt"][key], opt.state_dict()[key], SHARDED_STATE)
    # every rank's shards: JAX's declared layout, leaf by leaf
    sizes = {"data": 2, "model": 2, "seq": 1, "pipe": 1, "expert": 2}
    for o in outs:
        assert tmesh.coords_of(outs.index(o), sizes) == o["coords"]
        for key, shape in o["shapes"].items():
            assert shape == _shard_shape(sd[key].shape, layout[key], sizes), key

    # train_model: the loader's data shards make one process's global
    # batches, and the save holds full tensors, one process's save
    assert len(ref1) >= 8
    for r in joined:
        assert _rel(r["train"]["losses"][0], ref1) <= RUN_LOSS
    got = ckpt.load_checkpoint(os.path.join(tmp_path, "sharded", "checkpoints",
                                            "ckpt_ep_000.pth"))
    ref = ckpt.load_checkpoint(os.path.join(ref_dir, "checkpoints", "ckpt_ep_000.pth"))
    _state_close(got["model"], ref["model"], SHARDED_STATE, len(ref1))
    _state_close(got["opt"]["m"], ref["opt"]["m"], SHARDED_STATE, len(ref1))
    # one process resumes it for epoch 2, as it resumes its own save
    resumed = str(tmp_path / "resumed")
    shutil.copytree(os.path.join(tmp_path, "sharded"), resumed)
    rec = _train_model_f64(_run_opts(pack, resumed, 2, 2))
    assert [r["epoch"] for r in rec] == [1]
    ref_rec = _train_model_f64(_run_opts(pack, ref_dir, 2, 2))
    assert _rel(rec[0]["losses"], ref_rec[0]["losses"]) <= RUN_LOSS
    _state_close(ckpt.load_checkpoint(os.path.join(resumed, "checkpoints",
                                                   "ckpt_ep_001.pth"))["model"],
                 ckpt.load_checkpoint(os.path.join(ref_dir, "checkpoints",
                                                   "ckpt_ep_001.pth"))["model"], SHARDED_STATE,
                 2 * len(ref1))
    for d in ("sharded", "ref", "resumed", "stanza"):  # f64 saves: about 440 MB
        shutil.rmtree(tmp_path / d, ignore_errors=True)


def test_vit_tiny_moe_on_the_legacy_model_axis(tmp_path):
    """``vit_tiny_moe`` at ``MESH.MODEL 2``: the experts ride the model axis
    beside the column-parallel Linears; two f64 steps on 2 ranks follow the
    unsharded run, and each rank holds half the experts."""
    _, variables = _jax_variables("vit_tiny_moe", num_classes=10)
    sd = state_dict_from_jax(variables)
    torch.save(sd, tmp_path / "w.pt")
    batches = _vit_batches()
    torch.save(batches, tmp_path / "b.pt")
    ranks = Ranks(2, [{"name": "vit", "kind": "lockstep", "yaml": VIT_YAML, "opts": VIT_OPTS,
                       "weights": str(tmp_path / "w.pt"), "batches": str(tmp_path / "b.pt")}],
                  tmp_path, "vit")
    want, _, model, _ = _unsharded(VIT_YAML, VIT_OPTS, sd, batches)
    layout = _jax_layout("vit_tiny_moe", ["MESH.MODEL", 2, "MODEL.NUM_CLASSES", 10], VIT_YAML)
    outs = [r["vit"] for r in ranks.join()]
    for o in outs:
        assert _rel(o["losses"], want) <= SHARDED_LOSS
        assert o["shapes"]["blocks.1.mlp.w_in"][0] == 4
        sizes = {"data": 1, "model": 2, "seq": 1, "pipe": 1, "expert": 1}
        for key, shape in o["shapes"].items():
            assert shape == _shard_shape(sd[key].shape, layout[key], sizes), key
    _state_close(outs[0]["state"]["model"], model.state_dict(), SHARDED_STATE)


def _jax_layout(arch: str, opts: list, yaml: str) -> dict:
    """JAX's declared ``state_layout`` of the configured stanza on the
    8-device CPU mesh, as ``{port key: spec in the port's layout}``."""
    jconfig.reset_cfg()
    jcfg.merge_from_file(yaml)
    jcfg.merge_from_list([*opts, "LM.SEQ_LEN", SEQ, "TRAIN.IM_SIZE", 32])
    try:
        topo = jtopo.from_cfg(jcfg, n_devices=8)
        mesh = jmesh.mesh_from_cfg(jcfg)
        model = jtrainer.build_model_from_cfg(topo)
        layout = jspecs.state_layout(model, mesh, 32, 0)["params"]
    finally:
        jconfig.reset_cfg()
    flat = jax.tree_util.tree_flatten_with_path(layout)[0]
    tree = {}
    for path, sh in flat:
        node = tree
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = sh
    paths = jax_path_map(tree)
    out = {}
    for path, sh in flat:
        keys = tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)
        spec = tuple(sh.spec) + (None,) * (3 - len(sh.spec))
        key = paths[keys]
        if key.endswith(".weight") and len(keys) > 1 and keys[-1] == "kernel":
            spec = (spec[1], spec[0], spec[2])  # [in, out] -> torch's [out, in]
        out[key] = spec
    return out


def _shard_shape(full, spec, sizes) -> tuple:
    shape = list(full)
    for dim, axis in enumerate(spec[:len(shape)]):
        if axis is not None:
            shape[dim] //= sizes[axis]
    return tuple(shape)


@pytest.mark.parametrize("arch,opts,yaml", [
    ("gpt_nano_moe", [], GPT_YAML),
    ("vit_tiny_moe", ["MESH.MODEL", 2, "MODEL.NUM_CLASSES", 10], VIT_YAML),
    ("gpt_nano", ["MESH.MODEL", 2, "MESH.EXPERT", 1, "MODEL.ARCH", "gpt_nano"], GPT_YAML),
], ids=["gpt_nano_moe", "vit_tiny_moe-model2", "gpt_nano-model2"])
def test_spec_table_declares_what_jax_state_layout_does(arch, opts, yaml):
    """The port's table says, leaf by leaf, the axis JAX's ``state_layout``
    declares for the same arch and stanza (its Dense kernels transposed),
    and ``shard_state_dict`` / ``assemble`` round-trip every rank's shard."""
    layout = _jax_layout(arch, opts, yaml)
    reset_port_cfg()
    tconfig.merge_from_file(yaml)
    tcfg.merge_from_list([*opts, "LM.SEQ_LEN", SEQ, "TRAIN.IM_SIZE", 32])
    topo = ttopo.from_cfg(tcfg, 8)
    table = tspecs.table_for(tcfg.MODEL.ARCH, topo.moe_axis())
    for key, spec in layout.items():
        mine = table.spec_for(key)
        mine = tuple(mine) + (None,) * (3 - len(mine))
        assert mine == spec, (key, mine, spec)
    sd = trainer.build_model_from_cfg().state_dict()
    assert set(sd) == set(layout)
    sizes = topo.axes
    shards = {r: tspecs.shard_state_dict(sd, table, sizes, tmesh.coords_of(r, sizes))
              for r in range(8)}
    for r, part in shards.items():
        for key, t in part.items():
            assert tuple(t.shape) == _shard_shape(sd[key].shape, layout[key], sizes), key
    back = assemble(shards, table, sizes)
    for key, t in sd.items():
        assert torch.equal(back[key], t), key


ARCHS = ["resnet18", "vit_tiny", "vit_tiny_moe", "gpt_nano", "gpt_nano_moe"]


def _factorizations(n: int, k: int):
    if k == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, k - 1):
                yield (d,) + rest


def test_topology_accepts_and_refuses_what_jax_does():
    """Every factorization of 8 devices over the five axes, ZeRO 0-3, and
    the ViT, GPT, MoE and CNN archs: the port's rules refuse exactly the
    stanzas JAX's refuse, with the same rule and message; of the accepted
    ones (``tools/mesh_sweep.generate_cases(8)`` among them), a pipe or
    sequence axis or a model axis on a CNN raises ``not_ported`` after the
    rules, and the rest (ZeRO stages 1 and 3 among them) resolve to JAX's
    topology."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import mesh_sweep
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    cases = [(c["arch"], tuple(c["axes"][a] for a in ttopo.MESH_AXES), c["zero"])
             for c in mesh_sweep.generate_cases(8)]
    assert len(cases) >= 20
    space = [(arch, sizes, zero) for arch in ARCHS for sizes in _factorizations(8, 5)
             for zero in (0, 1, 2, 3)]
    refused = accepted = unported = 0
    for arch, sizes, zero in cases + space:
        jt = jtopo.Topology(*sizes, zero=zero)
        tt = ttopo.Topology(*sizes, zero=zero)
        try:
            jtopo.validate(jt, arch, jcfg.MODEL.MOE)
            jmsg = None
        except jtopo.TopologyError as e:
            jmsg = str(e)
        try:
            ttopo.validate(tt, arch, tcfg.MODEL.MOE)
            tmsg = rule = None
        except ttopo.TopologyError as e:
            tmsg, rule = str(e), e.rule
        assert tmsg == jmsg, (arch, sizes, zero)
        if jmsg is not None:
            refused += 1
            first = next(r for r in jtopo.RULES if r.check(jt, arch, jcfg.MODEL.MOE))
            assert rule == first.name
            continue
        accepted += 1
        expect = (tt.pipe > 1 or tt.seq > 1
                  or (tt.model > 1 and not arch.startswith(("vit", "gpt"))))
        try:
            ttopo.refuse_unported(tt, arch)
        except NotImplementedError as e:
            assert expect and "Parallel layouts beyond DP" in str(e), (arch, sizes, zero)
            unported += 1
        else:
            assert not expect and tt.class_name() == jt.class_name()
    assert refused and accepted and unported
    reset_port_cfg()
    tconfig.merge_from_file(GPT_YAML)
    assert ttopo.from_cfg(tcfg, 8).class_name() == "dp2·tp2·ep2"
    assert ttopo.from_cfg(tcfg, 4).class_name() == "tp2·ep2"
    tcfg.MESH.SEQ = 2
    with pytest.raises(ttopo.TopologyError, match="MESH.EXPERT=2 with MESH.SEQ=2") as e:
        ttopo.from_cfg(tcfg, 8)
    assert e.value.rule == "expert_seq"
    assert list(itertools.islice(_factorizations(8, 5), 1)) == [(1, 1, 1, 1, 8)]
