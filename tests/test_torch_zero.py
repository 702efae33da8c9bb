"""ZeRO's layout in the port (distribuuuu_tpu_torch/parallel/zero.py)
against the JAX package's (distribuuuu_tpu/parallel/zero.py,
parallel/partition/specs.py), with no process group.

* ``add_data_axis``/``strip_data_axis`` on a grid of shapes, base specs
  and data sizes: the same specs.
* Each leaf's ZeRO spec of resnet18, vit_tiny and gpt_nano at dp2, dp4
  and (the ViT and the GPT) dp2·tp2, chosen on the JAX layout and mapped
  through the transpose: equal, leaf for leaf through ``jax_path_map``,
  to JAX's ``state_layout(..., zero)`` on the CPU mesh, and every rank's
  block (its model slice, then its data shard) the elements JAX's
  sharding gives that device.
* The gather groups and the gather schedule at ``GATHER_AHEAD`` -1, 0, 1
  and 2, and JAX's ValueError below -1; the ``zero.schedule`` record's
  fields against JAX's ``_log_zero_schedule``.
* The per-shard plain update: bitwise the whole-leaf update restricted to
  the shard (SGD with an f32 and a bf16 trace, AdamW), and bitwise JAX's
  ``per_shard_update`` of its fused kernel (interpret mode) on a
  two-device CPU mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_port_util import few_threads, reset_port_cfg

from distribuuuu_tpu import config as jconfig
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.ops.pallas import opt_update as jou
from distribuuuu_tpu.parallel import mesh as jmesh
from distribuuuu_tpu.parallel import zero as jzero
from distribuuuu_tpu.parallel.partition import lowering as jlowering
from distribuuuu_tpu.parallel.partition import specs as jspecs
from distribuuuu_tpu.parallel.partition import topology as jtopo
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import config as tconfig
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.ops.cuda import opt_update
from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
from distribuuuu_tpu_torch.parallel import zero
from distribuuuu_tpu_torch.parallel.partition import specs
from distribuuuu_tpu_torch.utils.weights import jax_path_map, port_path_map

YAMLS = {"resnet18": "config/resnet18.yaml", "vit_tiny": "config/vit_tiny.yaml",
         "gpt_nano": "config/gpt_nano.yaml"}
IM, SEQ = 32, 32
STANZAS = {"dp2": {"data": 2}, "dp4": {"data": 4}, "dp2tp2": {"data": 2, "model": 2}}
CASES = [("resnet18", "dp2"), ("resnet18", "dp4"), ("vit_tiny", "dp2"), ("vit_tiny", "dp4"),
         ("vit_tiny", "dp2tp2"), ("gpt_nano", "dp2"), ("gpt_nano", "dp4"),
         ("gpt_nano", "dp2tp2")]


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()
    jconfig.reset_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _opts(arch: str, axes: dict) -> list:
    return ["MESH.DATA", axes["data"], "MESH.MODEL", axes.get("model", 1),
            "TRAIN.IM_SIZE", IM, "LM.SEQ_LEN", SEQ, "MODEL.NUM_CLASSES",
            320 if arch.startswith("gpt") else 10]


def _norm(spec) -> tuple:
    """A JAX PartitionSpec entry by entry (a one-name tuple as the name)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_layout(arch: str, stanza: str, stage: int):
    """JAX's ``state_layout`` at ``stage`` on a CPU mesh of the stanza's
    devices, with the mesh and the topology."""
    axes = STANZAS[stanza]
    n = axes["data"] * axes.get("model", 1)
    jconfig.reset_cfg()
    jcfg.merge_from_file(YAMLS[arch])
    jcfg.merge_from_list([*_opts(arch, axes), "MESH.ZERO", stage])
    try:
        topo = jtopo.from_cfg(jcfg, n_devices=n)
        mesh = jmesh.mesh_from_cfg(jcfg, devices=jax.devices()[:n])
        model = jtrainer.build_model_from_cfg(topo)
        layout = jspecs.state_layout(model, mesh, IM, stage)
    finally:
        jconfig.reset_cfg()
    return layout, mesh, topo


def _by_port_key(tree) -> dict:
    """``{port key: leaf}`` of a JAX params-shaped tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    nested: dict = {}
    for path, leaf in flat:
        node = nested
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return {key: _get(nested, p) for p, key in jax_path_map(nested).items()
            if _has(nested, p)}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _has(tree, path) -> bool:
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return False
        tree = tree[p]
    return True


def _port(arch: str, stanza: str, stage: int):
    """The port's unplaced model of the arch and its ZeRO plan on the
    stanza's mesh sizes (rank 0's coordinates; the specs and dims do not
    depend on them)."""
    axes = STANZAS[stanza]
    tconfig.merge_from_file(YAMLS[arch])
    tcfg.merge_from_list([*_opts(arch, axes), "DEVICE.PLATFORM", "cpu",
                          "DEVICE.COMPUTE_DTYPE", "float32"])
    model = trainer.build_model_from_cfg()
    sizes = {**dict.fromkeys(mesh_lib.MESH_AXES, 1), **axes}
    mesh = mesh_lib.Mesh(sizes, dict.fromkeys(mesh_lib.MESH_AXES, 0),
                         dict.fromkeys(mesh_lib.MESH_AXES))
    return model, mesh, zero.plan_model(model, mesh, stage, arch,
                                        port_path_map(model.state_dict()))


GRID_SHAPES = [(64,), (8192,), (16384,), (128, 128), (384, 1152), (7, 8192), (100, 100),
               (3, 3, 64, 64), (1, 1, 256, 512), (7, 7, 3, 64), (4, 192, 768), (1, 65, 192)]
GRID_SPECS = [P(), P(None, "model"), P("model"), P(None, None, "model"),
              P(("model", "expert")), P("expert", None, None)]


@pytest.mark.parametrize("data_size", [1, 2, 4, 8])
def test_add_and_strip_data_axis_match_jax(data_size):
    sizes = {"model": 2, "expert": 2, "data": data_size}
    for shape in GRID_SHAPES:
        for spec in GRID_SPECS:
            if len(tuple(spec)) > len(shape):
                continue
            want = jzero.add_data_axis(spec, shape, data_size, sizes)
            got = zero.add_data_axis(_norm(spec), shape, data_size, sizes)
            assert got == _norm(want), (shape, spec)
            assert zero.strip_data_axis(got) == _norm(jzero.strip_data_axis(want))


@pytest.mark.parametrize("arch,stanza", CASES)
def test_leaf_specs_and_shards_match_state_layout(arch, stanza):
    """Stage 1's grads and stage 3's params: each port leaf's spec, in the
    JAX dim order, is JAX's; each device's block of each leaf is the same
    elements (index ranges in the JAX layout)."""
    model, mesh, plan = _port(arch, stanza, 3)
    layout1, jmesh_, _ = _jax_layout(arch, stanza, 1)
    layout3, _, _ = _jax_layout(arch, stanza, 3)
    grads, params3 = _by_port_key(layout1["grads"]), _by_port_key(layout3["params"])
    params1 = _by_port_key(layout1["params"])
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(grads) == set(full)
    table = specs.table_for(arch, "model")
    sizes = mesh.sizes
    devs = np.asarray(jmesh_.devices).reshape(sizes["data"], sizes["model"])
    split = 0
    for leaf in plan.leaves:
        key = leaf.name
        jspec = _norm(grads[key].spec)
        jspec = jspec + (None,) * (len(full[key]) - len(jspec))
        assert zero.to_jax(key, leaf.spec) == jspec, key
        assert _norm(params3[key].spec) == _norm(grads[key].spec), key
        assert zero.strip_data_axis(zero.to_jax(key, leaf.spec)) == \
            _norm(params1[key].spec) + (None,) * (len(jspec) - len(_norm(params1[key].spec)))
        split += leaf.zdim is not None
        jshape = zero.to_jax(key, full[key])
        index = grads[key].devices_indices_map(jshape)
        tp = specs.split_of(table, key, sizes)
        for d in range(sizes["data"]):
            for m in range(sizes["model"]):
                rng = [[0, n] for n in full[key]]
                if tp is not None:
                    k = full[key][tp[1]] // sizes["model"]
                    rng[tp[1]] = [m * k, (m + 1) * k]
                if leaf.zdim is not None:
                    a, b = rng[leaf.zdim]
                    k = (b - a) // sizes["data"]
                    rng[leaf.zdim] = [a + d * k, a + (d + 1) * k]
                want = [list(sl.indices(n)[:2]) for sl, n in
                        zip(index[devs[d, m]], jshape)]
                assert list(zero.to_jax(key, tuple(rng))) == want, (key, d, m)
    assert split == sum(1 for g in grads.values() if "data" in jspecs.spec_axes(g.spec)) > 0


@pytest.mark.parametrize("arch", list(YAMLS))
def test_gather_groups_and_schedule_match_jax(arch):
    stanza = "dp2"
    layout, _, _ = _jax_layout(arch, stanza, 3)
    groups = _by_port_key(jspecs.gather_groups(layout))
    _, _, plan = _port(arch, stanza, 3)
    assert {leaf.name: leaf.group for leaf in plan.leaves} == groups
    for ahead in (-1, 0, 1, 2):
        want = _by_port_key(jspecs.gather_schedule(layout, ahead))
        got = dict(zip((leaf.name for leaf in plan.leaves), zero.gather_schedule(plan, ahead)))
        assert got == want, ahead
    bound = jspecs.collective_expectations(layout, jtopo.Topology(data=2, zero=3), -1)
    assert zero.gather_bound(plan, -1) == bound["gather_bound"]
    assert zero.gather_bound(plan, 0) == jspecs.collective_expectations(
        layout, jtopo.Topology(data=2, zero=3), 0)["gather_bound"]
    with pytest.raises(ValueError) as j:
        jspecs.gather_schedule(layout, -2)
    with pytest.raises(ValueError) as t:
        zero.gather_schedule(plan, -2)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("arch,stanza,stage,ahead,overlap", [
    ("resnet18", "dp2", 1, -1, True), ("vit_tiny", "dp2tp2", 3, 2, False),
    ("gpt_nano", "dp4", 3, 0, True)])
def test_zero_schedule_record_matches_jax(arch, stanza, stage, ahead, overlap, monkeypatch):
    layout, _, topo = _jax_layout(arch, stanza, stage)
    seen = {}
    import distribuuuu_tpu.utils.jsonlog as jjsonlog
    from distribuuuu_tpu_torch.utils import jsonlog as tjsonlog

    monkeypatch.setattr(jjsonlog, "metrics_log", lambda kind, **f: seen.setdefault("jax", f))
    monkeypatch.setattr(tjsonlog, "metrics_log", lambda kind, **f: seen.setdefault("port", f))
    monkeypatch.setattr(jlowering, "_logged_schedules", set())
    monkeypatch.setattr(zero, "_logged_schedules", set())
    jcfg.merge_from_list(["ZERO.GATHER_AHEAD", ahead, "ZERO.OVERLAP", overlap])
    jlowering._log_zero_schedule(layout, topo)
    _, _, plan = _port(arch, stanza, stage)
    assert zero.log_schedule(plan, overlap, ahead) == seen["jax"] == seen["port"]
    assert zero.log_schedule(plan, overlap, ahead) is None  # recorded once


# -- the per-shard update -------------------------------------------------------

UPDATE_CASES = {
    "sgd_nesterov_f32": dict(kind="sgd", mom=0.9, nesterov=True, mdt="float32"),
    "sgd_nesterov_bf16": dict(kind="sgd", mom=0.9, nesterov=True, mdt="bfloat16"),
    "adamw": dict(kind="adamw", mom=0.9, nesterov=False, mdt="float32"),
}
SHAPES = {"w": (96, 256), "k": (3, 3, 16, 64), "b": (64,), "t": (8192,)}


def _update_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    return params, grads


def _hyper(case) -> opt_update.Hyper:
    return opt_update.Hyper(kind=case["kind"], wd=float(tconfig._CFG_DEFAULT.OPTIM.WEIGHT_DECAY),
                            mom=case["mom"] if case["kind"] == "sgd" else 0.0,
                            nesterov=case["nesterov"], b1=0.9, b2=0.999, eps=1e-8)


@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_per_shard_update_is_the_whole_leaf_update_and_jax(name):
    """Two steps on each data rank's shards (dims chosen by
    ``add_data_axis`` at dp2) with the shard moments: bitwise the
    whole-leaf plain update's slice, and bitwise JAX's ``per_shard_update``
    of its fused kernel on a two-device mesh."""
    case = UPDATE_CASES[name]
    h = _hyper(case)
    mdt = torch.bfloat16 if case["mdt"] == "bfloat16" else torch.float32
    params, grads = _update_inputs()
    n = 2
    jspec = {k: jzero.add_data_axis(P(), s, n, {"data": n}) for k, s in SHAPES.items()}
    zdim = {k: next((i for i, e in enumerate(_norm(jspec[k])) if e == "data"), None)
            for k in SHAPES}
    assert sum(z is not None for z in zdim.values()) == 3  # the bias stays whole
    keys = list(SHAPES)

    def run(tensors, gs, shard):
        ps = [tensors[k].clone() for k in keys]
        ms = [torch.zeros_like(p, dtype=mdt if h.body() == "sgd" else p.dtype) for p in ps]
        vs = [torch.zeros_like(p) for p in ps] if h.body() == "adamw" else None
        for step, lr in ((1, 0.1), (2, 0.05)):
            scal = opt_update.staged_scalars(h, lr, step, ps, ms)
            opt_update.update(ps, [shard(k, gs[k]) for k in keys], ms, vs, h, scal)
        return ps, ms, vs

    whole = run({k: torch.from_numpy(v) for k, v in params.items()},
                {k: torch.from_numpy(v) for k, v in grads.items()}, lambda k, g: g)
    shards = []
    for r in range(n):
        def cut(k, t, r=r):
            return t if zdim[k] is None else zero.shard_of(t, zdim[k], n, r).contiguous()
        shards.append(run({k: cut(k, torch.from_numpy(v)) for k, v in params.items()},
                          {k: torch.from_numpy(v) for k, v in grads.items()}, cut))
        for i, k in enumerate(keys):
            for got, want in zip(shards[r], whole):
                if got is None:
                    continue
                w = want[i] if zdim[k] is None else zero.shard_of(want[i], zdim[k], n, r)
                assert torch.equal(got[i], w), (name, k, r)
    # JAX's per-shard fused update on the CPU mesh
    jcfg.defrost()
    jcfg.OPTIM.OPTIMIZER = case["kind"]
    jcfg.OPTIM.MOMENTUM = case["mom"]
    jcfg.OPTIM.NESTEROV = case["nesterov"]
    jcfg.OPTIM.MOMENTUM_DTYPE = case["mdt"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    layout = {"grads": {k: NamedSharding(mesh, jspec[k]) for k in keys}}
    update = functools.partial(
        jou.fused_optimizer_update, kind=case["kind"], wd=float(jcfg.OPTIM.WEIGHT_DECAY),
        mom=float(jcfg.OPTIM.MOMENTUM), nesterov=bool(jcfg.OPTIM.NESTEROV),
        b1=float(jcfg.OPTIM.BETA1), b2=float(jcfg.OPTIM.BETA2), eps=1e-8, interpret=True)
    step = jax.jit(jou.per_shard_update(update, layout))
    jp = {k: jax.device_put(jnp.asarray(v), layout["grads"][k]) for k, v in params.items()}
    jg = {k: jax.device_put(jnp.asarray(v), layout["grads"][k]) for k, v in grads.items()}
    state = jax_construct_optimizer().init(jp)
    for lr in (0.1, 0.05):
        state.hyperparams["learning_rate"] = lr
        jp, state = step(jp, jg, state)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(np.asarray(jp[k]), whole[0][i].numpy(), err_msg=k)
