"""Train a classification model with the port (the twin of the top-level
``train_net.py``). Runs on ``cuda:0`` unless ``DEVICE.PLATFORM cpu``; under
``torchrun`` or Slurm each process takes ``cuda:LOCAL_RANK`` and joins the
process group (``parallel/dist.py``).

Usage:
    python -m distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml \\
        TRAIN.DATASET <root> TEST.DATASET <root> [KEY VALUE ...]
    torchrun --nproc_per_node 8 -m distribuuuu_tpu_torch.train_net \\
        --cfg config/resnet50.yaml TRAIN.DATASET <root> TEST.DATASET <root>
    python -m distribuuuu_tpu_torch.train_net --cfg config/resnet50.yaml \\
        MODEL.DUMMY_INPUT True
    DISTRIBUUUU_GROUP_CONV=pallas python -m distribuuuu_tpu_torch.train_net \\
        --cfg config/regnety_160.yaml MODEL.DUMMY_INPUT True
"""

from __future__ import annotations

import distribuuuu_tpu_torch.config as config
from distribuuuu_tpu_torch.config import cfg


def main(argv=None):
    config.load_cfg_from_args("Train a classification model.", argv)
    cfg.freeze()
    from distribuuuu_tpu_torch import trainer

    return trainer.train_model()


if __name__ == "__main__":
    main()
