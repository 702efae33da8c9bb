"""The port's config (distribuuuu_tpu_torch/config.py): every shipped image
config merges into it unchanged, its defaults equal the JAX package's for
every key both hold, and the kernel knob accepts only ``auto``."""

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
    for key, value in _leaves(tcfg):
        assert key in jax_leaves, key
        assert value == jax_leaves[key], key


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
