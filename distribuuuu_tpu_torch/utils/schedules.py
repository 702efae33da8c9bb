"""Learning-rate schedules (counterpart of distribuuuu_tpu/utils/schedules.py).

Epoch-granular: the step policy ``LR_MULT ** idx`` over ``STEPS``, the
half-period cosine with a relative ``MIN_LR`` floor, and a linear warmup
from ``WARMUP_FACTOR`` to 1 over ``WARMUP_EPOCHS``, all times ``BASE_LR``.
"""

from __future__ import annotations

import numpy as np

from distribuuuu_tpu_torch.config import cfg


def lr_fun_steps(cur_epoch: float) -> float:
    """Piecewise-constant decay: LR_MULT ** (index of the current band)."""
    steps = list(cfg.OPTIM.STEPS)
    if not steps or steps[0] != 0:
        steps = [0] + steps
    ind = [i for i, s in enumerate(steps) if cur_epoch >= s][-1]
    return float(cfg.OPTIM.LR_MULT) ** ind


def lr_fun_cos(cur_epoch: float) -> float:
    """Half-period cosine, floored at the relative MIN_LR."""
    base = 0.5 * (1.0 + np.cos(np.pi * cur_epoch / cfg.OPTIM.MAX_EPOCH))
    return (1.0 - cfg.OPTIM.MIN_LR) * base + cfg.OPTIM.MIN_LR


_POLICIES = {"steps": lr_fun_steps, "cos": lr_fun_cos}


def get_lr_fun():
    if cfg.OPTIM.LR_POLICY not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {cfg.OPTIM.LR_POLICY}")
    return _POLICIES[cfg.OPTIM.LR_POLICY]


def get_epoch_lr(cur_epoch: float) -> float:
    """The absolute learning rate of an epoch: policy × BASE_LR, with the
    linear warmup."""
    lr = get_lr_fun()(cur_epoch) * cfg.OPTIM.BASE_LR
    if cur_epoch < cfg.OPTIM.WARMUP_EPOCHS:
        alpha = cur_epoch / cfg.OPTIM.WARMUP_EPOCHS
        lr *= cfg.OPTIM.WARMUP_FACTOR * (1.0 - alpha) + alpha
    return float(lr)
