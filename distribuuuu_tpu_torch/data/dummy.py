"""Fake-data backend (counterpart of distribuuuu_tpu/data/dummy.py).

Random NHWC images with label 0 behind ``MODEL.DUMMY_INPUT``, made per
sample from ``default_rng(index)``: the training path runs with no dataset
on disk, and its batches are byte-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np


class DummyDataset:
    """``length`` random ``size``×``size`` images, label 0; uint8 under
    ``raw_u8`` (``DATA.DEVICE_NORMALIZE``), else standard-normal float32."""

    def __init__(self, length: int = 6400, size: int = 224, raw_u8: bool = False):
        self.length = length
        self.size = size
        self.raw_u8 = raw_u8

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(idx)
        if self.raw_u8:
            return rng.integers(0, 256, (self.size, self.size, 3), dtype=np.uint8), 0
        return rng.standard_normal((self.size, self.size, 3), dtype=np.float32), 0
