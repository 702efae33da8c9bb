"""The port's config (distribuuuu_tpu_torch/config.py): every shipped
config merges into it unchanged, it holds exactly the JAX package's keys
with its defaults, a key whose mechanism is not ported raises naming its
ROADMAP item, and the kernel knob accepts only ``auto``."""

from __future__ import annotations

import pytest
from torch_port_util import reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg

IMAGE_CONFIGS = [
    "resnet18", "resnet50", "botnet50", "efficientnet_b0", "regnetx_160",
    "regnety_160", "regnety_320", "vit_tiny", "vit_small", "vit_tiny_moe",
]


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.mark.parametrize("name", IMAGE_CONFIGS)
def test_shipped_image_config_merges(name):
    tconfig.merge_from_file(f"config/{name}.yaml")
    assert tcfg.MODEL.ARCH == name


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_defaults_match_jax_package():
    jax_leaves = dict(_leaves(jcfg))
    port_leaves = dict(_leaves(tcfg))
    assert set(port_leaves) == set(jax_leaves)
    for key, value in port_leaves.items():
        assert value == jax_leaves[key], key


def _model_yamls():
    import glob
    import os

    import yaml

    out = []
    for path in sorted(glob.glob("config/*.yaml")):
        with open(path) as f:
            if "MODEL" in (yaml.safe_load(f) or {}):
                out.append(os.path.basename(path))
    return out


@pytest.mark.parametrize("name", _model_yamls())
def test_every_shipped_model_yaml_merges(name):
    """Every model YAML the JAX package ships (the MoE and sequence-parallel
    LM stanzas included) merges into the port's config: no KeyError."""
    tconfig.merge_from_file(f"config/{name}")
    assert tcfg.MODEL.ARCH


PARALLEL = "Parallel layouts beyond DP"
ASYNC = "Async, resilience, live plane, shards and analysis"
# (key, value, its Queue 1 item, what now takes over the refusal check:
# (overrides, launched processes) of the next unported value of the item,
# or None while the key itself is still refused)
UNPORTED_VALUES = [
    ("MESH.ZERO", 1, PARALLEL, (["MODEL.ARCH", "vit_tiny", "MESH.SEQ", 2], 2)),
    ("ZERO.OVERLAP", False, PARALLEL, (["MODEL.ARCH", "vit_tiny", "MESH.PIPE", 2], 2)),
    ("ZERO.GATHER_AHEAD", 2, PARALLEL, (["MESH.MODEL", 2], 2)),
    ("ASYNC.SEQUENCER", False, ASYNC, None),
    ("ASYNC.RING_DEADLINE_S", 5.0, ASYNC, None),
    ("ASYNC.BARRIER_TIMEOUT_S", 5.0, ASYNC, (["ASYNC.SEQUENCER", False], 1)),
]


@pytest.mark.parametrize("key,value,item,successor", UNPORTED_VALUES,
                         ids=[k for k, *_ in UNPORTED_VALUES])
def test_unported_keys_raise_naming_their_item(key, value, item, successor, monkeypatch):
    """Away from its default a key the port does not run raises
    ``NotImplementedError`` naming its Queue 1 item, not ``KeyError``; at
    its default, and for the inert ``COMPILE_CACHE`` and ``LOG_DEST``, the
    config is accepted. A key a later slice ported (ZeRO and its knobs, the
    commit barrier's timeout) is accepted away from its default, and the
    next unported value of its item takes over the refusal check (the
    sequence and pipe axes, a model axis on a CNN, the dispatch
    sequencer); ``MESH.ZERO 2`` and ``ZERO.GATHER_AHEAD -2`` raise as the
    JAX package's checks do."""
    tconfig.merge_from_file("config/resnet18.yaml")
    tcfg.merge_from_list(["COMPILE_CACHE.ENABLED", True, "LOG_DEST", "stderr"])
    trainer.check_train_cfg()
    tcfg.merge_from_list([key, value])
    if successor is None:
        with pytest.raises(NotImplementedError, match=item):
            trainer.check_train_cfg()
        return
    trainer.check_train_cfg()
    if key == "MESH.ZERO":
        tcfg.merge_from_list([key, 2])
        with pytest.raises(ValueError, match="MESH.ZERO=2: stages are 0"):
            trainer.check_train_cfg()
        tcfg.merge_from_list([key, value])
    if key == "ZERO.GATHER_AHEAD":
        tcfg.merge_from_list([key, -2])
        with pytest.raises(ValueError, match="ZERO.GATHER_AHEAD=-2: must be -1"):
            trainer.check_train_cfg()
        tcfg.merge_from_list([key, value])
    opts, world = successor
    if world > 1:
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("WORLD_SIZE", str(world))
    tcfg.merge_from_list(opts)
    with pytest.raises(NotImplementedError, match=item):
        trainer.check_train_cfg()


def test_overrides_and_freeze():
    tcfg.merge_from_list(["SERVE.BUCKET_SIZES", "[1, 2, 4]", "DEVICE.PLATFORM", "cpu"])
    assert tcfg.SERVE.BUCKET_SIZES == [1, 2, 4]
    tcfg.freeze()
    with pytest.raises(AttributeError, match="frozen"):
        tcfg.SERVE.MAX_BATCH = 2
    with pytest.raises(KeyError, match="Non-existent"):
        tcfg.merge_from_list(["ASYNC.ENABLED", "True"])


def test_kernel_knob_and_platform_refusals():
    tcfg.KERNELS.CONV_EPILOGUE = "xla"
    with pytest.raises(ValueError, match="accepts only"):
        trainer.build_model_from_cfg()
    reset_port_cfg()
    tcfg.DEVICE.PLATFORM = "tpu"
    with pytest.raises(ValueError, match="DEVICE.PLATFORM"):
        trainer.device_from_cfg()
    tcfg.DEVICE.PLATFORM = "cpu"
    assert str(trainer.device_from_cfg()) == "cpu"


def test_opt_update_knob_accepts_only_auto():
    tcfg.KERNELS.OPT_UPDATE = "pallas"
    with pytest.raises(ValueError, match="OPT_UPDATE.*accepts only"):
        trainer.build_model_from_cfg()
