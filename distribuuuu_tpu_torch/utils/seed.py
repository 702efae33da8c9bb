"""Seeding and environment setup (counterpart of distribuuuu_tpu/utils/seed.py).

The host RNGs (``random``, ``numpy``) are seeded from ``RNG_SEED + rank``
for incidental host randomness, as the reference seeds each rank; the
data path draws from per-sample generators seeded by ``(RNG_SEED, epoch,
index)`` and the weights from an explicit ``torch.Generator`` of the base
seed, so every rank builds the same weights and augments a sample the
same way. With ``RNG_SEED`` unset the primary draws the seed and
broadcasts it.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from distribuuuu_tpu_torch import config
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist


def setup_seed() -> torch.Generator:
    """Seed the host RNGs rank-offset and return the run's base
    ``torch.Generator`` (``RNG_SEED``, or a seed the primary draws)."""
    seed = cfg.RNG_SEED
    if seed is None:
        seed = dist.broadcast_from_primary(int.from_bytes(os.urandom(4), "little"))
    rank = dist.get_rank()
    np.random.seed(seed + rank)
    random.seed(seed + rank)
    return torch.Generator().manual_seed(int(seed))


def setup_env() -> None:
    """On the primary: create ``OUT_DIR`` and dump the merged config there."""
    if dist.is_primary():
        os.makedirs(cfg.OUT_DIR, exist_ok=True)
        config.dump_cfg()
