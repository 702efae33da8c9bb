"""Carrying weights into the port (distribuuuu_tpu_torch/utils/weights.py):
the JAX tree maps leaf for leaf onto the port's torchvision-named state
dict, torchvision-style ``.pth`` files load, and the formats the port
cannot read are refused."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_port_util import assemble, jax_resnet, random_variables, reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.serve import engine_from_cfg
from distribuuuu_tpu_torch.utils import weights


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, (*prefix, k))
        else:
            yield (*prefix, k), v


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "resnext50_32x4d"])
def test_every_jax_leaf_lands_in_exactly_one_port_tensor(arch):
    _, shapes = jax_resnet(arch)
    leaves = dict(_paths(shapes["params"])) | dict(_paths(shapes["batch_stats"]))
    mapping = weights.jax_path_map(shapes["params"])
    assert set(mapping) == set(leaves)
    assert len(set(mapping.values())) == len(mapping)  # injective
    port_sd = tmodels.build_model(arch, num_classes=10).state_dict()
    assert set(mapping.values()) == {k for k in port_sd if not k.endswith("num_batches_tracked")}

    sd = weights.state_dict_from_jax(*(random_variables(shapes)[k] for k in ("params", "batch_stats")))
    assert set(sd) == set(port_sd)
    for k, v in sd.items():
        assert v.shape == port_sd[k].shape, k


def test_conversion_layouts():
    _, shapes = jax_resnet("resnet18")
    v = random_variables(shapes, seed=5)
    sd = weights.state_dict_from_jax(v["params"], v["batch_stats"])
    p, s = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  p["ConvBN_0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), p["Dense_0"]["Dense_0"]["kernel"].T)
    bn = ("ConvBN_2", "BatchNorm_0", "BatchNorm_0")  # block 2 = layer2.0; ConvBN_2 = downsample
    blk = p["BasicBlock_2"]
    np.testing.assert_array_equal(sd["layer2.0.downsample.1.weight"].numpy(),
                                  blk[bn[0]][bn[1]][bn[2]]["scale"])
    np.testing.assert_array_equal(sd["layer2.0.downsample.1.running_var"].numpy(),
                                  s["BasicBlock_2"][bn[0]][bn[1]][bn[2]]["var"])
    np.testing.assert_array_equal(sd["layer4.1.conv2.weight"].numpy(),
                                  p["BasicBlock_7"]["ConvBN_1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


def test_unmapped_leaf_raises():
    _, shapes = jax_resnet("resnet18")
    v = random_variables(shapes)
    v["params"]["Dense_0"]["Dense_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no port tensor"):
        weights.state_dict_from_jax(v["params"], v["batch_stats"])


@pytest.mark.parametrize("wrap", [False, True])
def test_torchvision_pth_with_module_prefix_loads(tmp_path, wrap):
    src = tmodels.build_model("resnet18", num_classes=10,
                              generator=torch.Generator().manual_seed(7))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    path = tmp_path / ("ckpt.pth.tar" if wrap else "ckpt.pth")
    torch.save({"state_dict": sd, "epoch": 3} if wrap else sd, path)
    dst = tmodels.build_model("resnet18", num_classes=10)
    weights.load_weights(dst, str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_orbax_dir_and_pretrained_are_refused(tmp_path):
    """A directory is read as an orbax checkpoint (tests/test_torch_orbax.py):
    one that is not an orbax checkpoint is refused, and so is the URL zoo."""
    from distribuuuu_tpu_torch.utils.orbax import OrbaxFormatError

    with pytest.raises(OrbaxFormatError, match="no _METADATA"):
        weights.load_weights(tmodels.build_model("resnet18"), str(tmp_path))
    tconfig.merge_from_file("config/resnet18.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "MODEL.PRETRAINED", True,
                          "MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", 32])
    with pytest.raises(NotImplementedError, match="URL zoo"):
        engine_from_cfg()


def test_jax_tree_paths_come_from_model_init():
    """The mapper reads the paths ``model.init`` makes (flax auto-names),
    not a guessed layout: spot-check the tree it was given."""
    _, shapes = jax_resnet("resnet50")
    p = shapes["params"]
    assert set(p) == {"ConvBN_0", "Dense_0", *(f"Bottleneck_{i}" for i in range(16))}
    assert set(p["Bottleneck_0"]) == {f"ConvBN_{i}" for i in range(4)}
    assert set(p["Bottleneck_1"]) == {f"ConvBN_{i}" for i in range(3)}
    assert jax.tree.structure(shapes["batch_stats"]["ConvBN_0"]).num_leaves == 2


@pytest.mark.parametrize("arch", ["vit_tiny_moe", "gpt_nano_moe"])
def test_moe_leaves_round_trip_through_the_shards(arch, tmp_path):
    """A MoE model's ``MoeMlp_0/{gate, w_in, b_in, w_out, b_out}`` leaves
    land in ``blocks.N.mlp.*`` in the JAX layout (not transposed); every
    rank's ``shard_state_dict`` of a dp2·tp2·ep2 mesh reassembles to the
    whole, and a ``.pth`` of it loads into a model placed on one rank's
    shards."""
    import jax.numpy as jnp
    from flax import linen as nn

    from distribuuuu_tpu import models as jmodels
    from distribuuuu_tpu_torch.parallel import mesh as tmesh
    from distribuuuu_tpu_torch.parallel import tp
    from distribuuuu_tpu_torch.parallel.partition import specs

    gpt = arch.startswith("gpt")
    kw = dict(num_classes=320, seq_len=8) if gpt else dict(num_classes=8)
    jm = jmodels.build_model(arch, dim=32, depth=2, num_heads=2, moe_experts=4, **kw)
    dummy = jnp.zeros((2, 8), jnp.int32) if gpt else jnp.zeros((1, 32, 32, 3))
    shapes = nn.unbox(jax.eval_shape(lambda k: jm.init(k, dummy, train=False),
                                     jax.random.key(0)))
    params = random_variables(shapes["params"], seed=4)
    sd = weights.state_dict_from_jax(params)
    for leaf in weights.MOE_LEAVES:
        np.testing.assert_array_equal(sd[f"blocks.1.mlp.{leaf}"].numpy(),
                                      params["Block_1"]["MoeMlp_0"][leaf])
    sizes = {"data": 2, "model": 2, "seq": 1, "pipe": 1, "expert": 2}
    table = specs.table_for(arch, "expert")
    shards = {r: specs.shard_state_dict(sd, table, sizes, tmesh.coords_of(r, sizes))
              for r in range(8)}
    assert shards[1]["blocks.1.mlp.w_in"].shape[0] == 2
    back = assemble(shards, table, sizes)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    torch.save(sd, tmp_path / "w.pth")
    model = tmodels.build_model(arch, dim=32, depth=2, num_heads=2, moe_experts=4,
                                **({"num_classes": 320, "seq_len": 8} if gpt
                                   else {"num_classes": 8, "img_size": 32}))
    rank = tmesh.coords_of(5, sizes)
    model.shards = {k: tp.Shard(None, rank[table.spec_for(k)[d]], 2, d)
                    for k in sd for d in range(len(table.spec_for(k)))
                    if table.spec_for(k)[d] is not None}
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in model.shards:
                p.data = model.shards[k].take(p.data).clone()
    weights.load_weights(model, str(tmp_path / "w.pth"))
    got = model.state_dict()
    for k, v in shards[5].items():
        assert torch.equal(got[k], v), k


# -- torchvision's legacy DenseNet keys, and every arch's names both ways ------

DENSE_TOY = dict(growth_rate=8, block_config=(2, 3, 2, 2), num_init_features=16, bn_size=2)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _legacy(key: str) -> str:
    """torchvision's pre-0.3 DenseNet name of a port key
    (``denselayerN.norm1.weight`` → ``denselayerN.norm.1.weight``)."""
    import re

    return re.sub(r"(denselayer\d+\.(?:norm|relu|conv))([12])\.", r"\1.\2.", key)


def test_densenet_legacy_keys_load_in_both_packages(tmp_path, x64):
    """A DenseNet ``.pth`` under torchvision's legacy keys (``norm.1.``,
    ``conv.1.``) loads into the port (``load_weights``) and into the JAX
    package (``torch_ingest.convert_state_dict``, as its trainer loads
    ``MODEL.WEIGHTS``): the f64 eval logits agree to 1e-12."""
    import jax.numpy as jnp
    from torch_port_util import jax_model

    from distribuuuu_tpu.models.densenet import DenseNet as JaxDenseNet
    from distribuuuu_tpu.utils import torch_ingest
    from distribuuuu_tpu_torch.models import layers as tlayers
    from distribuuuu_tpu_torch.models.densenet import DenseNet

    jmodel, shapes = jax_model(JaxDenseNet(num_classes=10, dtype=jnp.float64, **DENSE_TOY))
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), random_variables(shapes, seed=3))
    sd = weights.state_dict_from_jax(v["params"], v["batch_stats"], keep_dtype=True)
    ref = tlayers.build_on(DenseNet, num_classes=10, dtype=torch.float64, **DENSE_TOY)
    ref.to(torch.float64).load_state_dict(sd)
    # torchvision's definition order, under its legacy names
    legacy = {_legacy(k): t for k, t in ref.state_dict().items()}
    assert sum(k != _legacy(k) for k in sd) > 40
    assert all(k.startswith("features.") or k.startswith("classifier") for k in legacy)
    path = tmp_path / "densenet_legacy.pth"
    torch.save({"state_dict": {f"module.{k}": t for k, t in legacy.items()}}, path)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3))
    port = weights.load_weights(tlayers.build_on(DenseNet, num_classes=10, dtype=torch.float64,
                                                 **DENSE_TOY).to(torch.float64), str(path))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    ingested = torch_ingest.convert_state_dict(
        {k: t.numpy() for k, t in legacy.items()},
        torch_ingest.ordered_variables(jmodel, im_size=32))
    want = np.asarray(jmodel.apply(ingested, jnp.asarray(x), train=False))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


ZOO = tmodels.available_models()


@pytest.mark.parametrize("arch", ZOO)
def test_every_arch_names_map_to_jax_paths_and_back(arch):
    """Each arch's reference (torchvision/timm) names, on the meta device at
    full width: every key but BN's counters has a JAX path
    (``port_path_map``), and ``jax_path_map`` of those paths gives the key
    back; a legacy-key remap leaves every non-DenseNet key alone."""
    kw = {"seq_len": 32} if arch.startswith("gpt") else {}
    if arch == "botnet50":
        kw["fmap_size"] = (14, 14)
    model = tmodels.build_model(arch, num_classes=10, device="meta", **kw)
    sd = model.state_dict()
    inv = weights.port_path_map(sd)
    assert set(inv) == {k for k in sd if not k.endswith("num_batches_tracked")}
    tree: dict = {}
    for key, path in inv.items():
        node = tree
        for p in path[1:-1]:
            node = node.setdefault(p, {})
        shape = tuple(sd[key].shape)  # the JAX leaf's (the map reads a kernel's width)
        node[path[-1]] = weights._Kernel(
            (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape)
    assert {v: k for k, v in weights.jax_path_map(tree).items()} == \
        {key: path[1:] for key, path in inv.items()}
    if not arch.startswith("densenet"):
        assert weights.densenet_legacy_keys(sd).keys() == sd.keys()


@pytest.mark.parametrize("arch", ["resnet18", "densenet121", "efficientnet_b0", "vit_tiny",
                                  "gpt_nano"])
def test_reference_named_pth_loads_by_name(arch, tmp_path):
    """A ``.pth`` under each arch's reference names loads through
    ``load_weights`` into a fresh model, tensor for tensor (a DenseNet's
    also under torchvision's legacy names)."""
    kw = {"seq_len": 32} if arch.startswith("gpt") else {}
    src = tmodels.build_model(arch, num_classes=10, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(1), **kw)
    sd = src.state_dict()
    names = {_legacy(k): t for k, t in sd.items()} if arch.startswith("densenet") else sd
    torch.save(names, tmp_path / "w.pth")
    dst = tmodels.build_model(arch, num_classes=10, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(2), **kw)
    weights.load_weights(dst, str(tmp_path / "w.pth"))
    for k, t in dst.state_dict().items():
        assert torch.equal(t, sd[k]), k
