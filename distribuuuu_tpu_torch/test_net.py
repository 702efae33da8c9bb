"""Evaluate a classification model with the port (the twin of the
top-level ``test_net.py``). Runs on ``cuda:0`` unless ``DEVICE.PLATFORM
cpu``; under ``torchrun`` or Slurm each process evaluates its shard of the
val split on ``cuda:LOCAL_RANK`` and the sums are all-reduced.

Usage:
    python -m distribuuuu_tpu_torch.test_net --cfg config/resnet50.yaml \\
        TEST.DATASET <root> MODEL.WEIGHTS path/to/weights.pth [KEY VALUE ...]
"""

from __future__ import annotations

import distribuuuu_tpu_torch.config as config
from distribuuuu_tpu_torch.config import cfg


def main(argv=None):
    config.load_cfg_from_args("Evaluate a classification model.", argv)
    cfg.freeze()
    from distribuuuu_tpu_torch import trainer

    return trainer.test_model()


if __name__ == "__main__":
    main()
