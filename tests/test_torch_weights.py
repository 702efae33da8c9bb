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
