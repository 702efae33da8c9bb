"""Model construction from the config (counterpart of the parts of
distribuuuu_tpu/trainer.py that serving reads). The training slice adds
the train and eval loops here."""

from __future__ import annotations

import torch

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.models.layers import resolve_dtype
from distribuuuu_tpu_torch.ops import cuda as kernel_tier


def bn_group_from_cfg() -> int:
    """BN statistic regime: ``SYNCBN True`` ⇒ 0 (global-batch stats);
    else ghost groups of ``MODEL.BN_GROUP``, defaulting to
    ``TRAIN.BATCH_SIZE``."""
    if cfg.MODEL.SYNCBN:
        return 0
    return cfg.MODEL.BN_GROUP or cfg.TRAIN.BATCH_SIZE


def device_from_cfg() -> torch.device:
    """``DEVICE.PLATFORM`` ``auto``/``cuda`` → ``cuda:{SERVE.DEVICE}``, which
    raises when CUDA is absent; ``cpu`` is the explicit CPU request."""
    platform = cfg.DEVICE.PLATFORM
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("auto", "cuda"):
        raise ValueError(
            f"DEVICE.PLATFORM={platform!r}: the port runs on 'auto' or 'cuda' "
            "(the card) or 'cpu' (tests)"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"DEVICE.PLATFORM={platform!r} needs a CUDA device and torch sees "
            "none; pass DEVICE.PLATFORM cpu to run on the CPU on purpose"
        )
    idx = int(cfg.SERVE.DEVICE)
    if not 0 <= idx < torch.cuda.device_count():
        raise ValueError(
            f"SERVE.DEVICE={idx} out of range: {torch.cuda.device_count()} CUDA devices"
        )
    return torch.device("cuda", idx)


def build_model_from_cfg():
    """The configured arch on the CPU, in fp32 master weights, filled from
    ``RNG_SEED`` (0 when unset) by a ``torch.Generator``."""
    kernel_tier.validate_kernels_cfg(cfg.KERNELS)
    if cfg.DEVICE.S2D_STEM:
        raise not_ported("DEVICE.S2D_STEM (space-to-depth stem)", "S2D stem")
    return build_model(
        cfg.MODEL.ARCH,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dtype=resolve_dtype(cfg.DEVICE.COMPUTE_DTYPE),
        bn_group=bn_group_from_cfg(),
        generator=torch.Generator().manual_seed(int(cfg.RNG_SEED or 0)),
    )


def effective_topk() -> int:
    """TOPK clamped to the class count."""
    return min(cfg.TRAIN.TOPK, cfg.MODEL.NUM_CLASSES)
