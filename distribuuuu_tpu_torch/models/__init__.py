"""Model registry of the port (counterpart of distribuuuu_tpu/models/__init__.py).

The ResNet family, the RegNets (regnetx_160, regnety_160, regnety_320),
DenseNet-121/161/169/201, BoTNet-50, EfficientNet-B0, the ViTs (vit_tiny,
vit_small), the MoE ViT-Ti (vit_tiny_moe), gpt_nano and gpt_nano_moe
are ported.
"""

from __future__ import annotations

from distribuuuu_tpu_torch.models.botnet import botnet50
from distribuuuu_tpu_torch.models.densenet import (
    densenet121,
    densenet161,
    densenet169,
    densenet201,
)
from distribuuuu_tpu_torch.models.efficientnet import efficientnet_b0
from distribuuuu_tpu_torch.models.gpt import gpt_nano, gpt_nano_moe
from distribuuuu_tpu_torch.models.regnet import regnetx_160, regnety_160, regnety_320
from distribuuuu_tpu_torch.models.resnet import (
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from distribuuuu_tpu_torch.models.vit import vit_small, vit_tiny, vit_tiny_moe

_REGISTRY = {
    fn.__name__: fn
    for fn in (
        resnet18, resnet34, resnet50, resnet101, resnet152,
        resnext50_32x4d, resnext101_32x8d, wide_resnet50_2, wide_resnet101_2,
        regnetx_160, regnety_160, regnety_320,
        densenet121, densenet161, densenet169, densenet201, botnet50, efficientnet_b0,
        vit_tiny, vit_small, vit_tiny_moe, gpt_nano, gpt_nano_moe,
    )
}


def available_models():
    return sorted(_REGISTRY)


def build_model(arch: str, **kwargs):
    """Construct a model by name. Keyword arguments go to the constructor
    (``num_classes``, ``dtype``, ``generator``, ``device``, ...)."""
    if arch not in _REGISTRY:
        raise KeyError(f"Unknown arch '{arch}'. Available: {', '.join(available_models())}.")
    return _REGISTRY[arch](**kwargs)
