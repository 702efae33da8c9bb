"""Seeding and environment setup (counterpart of distribuuuu_tpu/utils/seed.py).

The host RNGs (``random``, ``numpy``) are seeded from ``RNG_SEED`` for
incidental host randomness; the data path draws from per-sample generators
and the weights from an explicit ``torch.Generator``, never from them.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from distribuuuu_tpu_torch import config
from distribuuuu_tpu_torch.config import cfg


def setup_seed() -> torch.Generator:
    """Seed the host RNGs and return the run's base ``torch.Generator``
    (``RNG_SEED``, or a fresh random seed when it is unset)."""
    seed = cfg.RNG_SEED
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(int(seed))


def setup_env() -> None:
    """Create ``OUT_DIR`` and dump the merged config there."""
    os.makedirs(cfg.OUT_DIR, exist_ok=True)
    config.dump_cfg()
