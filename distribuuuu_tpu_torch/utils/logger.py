"""Logging: stdlib logging with the JAX package's shape (every process to
stderr tagged with its rank; only the primary writes
``{OUT_DIR}/{time}.log``). The rank comes from the process group
(``parallel/dist.py``), so set the logger up after joining it."""

from __future__ import annotations

import logging
import os
import sys
import time

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.parallel import dist

_LOGGER_NAME = "distribuuuu_tpu_torch"
_configured = False


def setup_logger() -> logging.Logger:
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if _configured:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False
    rank = dist.get_rank()
    fmt = logging.Formatter(
        fmt=f"%(asctime)s | %(levelname)s | p{rank} | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if rank == 0:
        os.makedirs(cfg.OUT_DIR, exist_ok=True)
        fh = logging.FileHandler(os.path.join(cfg.OUT_DIR, f"{time.time()}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.info("config:\n%s", cfg.dump())
    _configured = True
    return logger


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        # usable before setup (tests): stderr only, no file sink
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
