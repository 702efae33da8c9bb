"""One rank of the port's multi-process tests (tests/test_torch_ddp.py):
``python tests/torch_ddp_worker.py SPEC.json`` under the environment
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``). It joins a gloo process group and runs each
scenario of the spec in turn, on the CPU, writing ``{out}/rank{r}.pt``.
It imports no JAX: the test holds what it writes against the JAX
package."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distribuuuu_tpu_torch import models as tmodels  # noqa: E402
from distribuuuu_tpu_torch import trainer  # noqa: E402
from distribuuuu_tpu_torch.config import cfg  # noqa: E402
from distribuuuu_tpu_torch.data.loader import construct_val_loader  # noqa: E402
from distribuuuu_tpu_torch.parallel import dist  # noqa: E402
from distribuuuu_tpu_torch.resilience.supervisor import NonFiniteLossError  # noqa: E402
from distribuuuu_tpu_torch.utils.logger import get_logger  # noqa: E402
from distribuuuu_tpu_torch.utils.optim import construct_optimizer  # noqa: E402

CPU = torch.device("cpu")


def model_from(spec: dict, bn_group: int, dtype=torch.float64):
    model = tmodels.build_model("resnet18", num_classes=10, dtype=dtype, bn_group=bn_group)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    return model.to(dtype)


def lockstep(spec: dict, sc: dict) -> dict:
    """``steps`` train steps at f64 on this rank's slice of each global
    batch (``accum`` micro-batches a step): the losses and the final
    state."""
    rank, world = dist.get_rank(), dist.get_world_size()
    model = model_from(spec, sc["bn_group"]).train()
    opt = construct_optimizer(model)
    data = np.load(spec["batches"])
    losses = []
    for i in range(sc["steps"]):
        n = data[f"image_{i}"].shape[0] // world
        part = slice(rank * n, (rank + 1) * n)
        batch = {"image": torch.from_numpy(data[f"image_{i}"][part]),
                 "label": torch.from_numpy(data[f"label_{i}"][part])}
        losses.append(float(trainer.train_step(model, opt, batch, 5,
                                               accum=sc.get("accum", 1))["loss"]))
    return {"losses": losses, "state": model.state_dict()}


def evaluate(spec: dict, sc: dict) -> dict:
    """``validate`` over this rank's shard of the val tree, sums
    all-reduced."""
    model = model_from(spec, 0).to(CPU)
    return {"result": trainer.validate(construct_val_loader(), model, 0, get_logger(), CPU)}


class TwoBatches:
    """Two batches of the global batch 0, this rank's slice; rank 1's
    first one is NaN."""

    def __init__(self, spec):
        data = np.load(spec["batches"])
        rank, world = dist.get_rank(), dist.get_world_size()
        n = data["image_0"].shape[0] // world
        image = data["image_0"][rank * n:(rank + 1) * n].astype(np.float32)
        label = data["label_0"][rank * n:(rank + 1) * n]
        first = image * np.nan if rank == 1 else image
        self.batches = [{"image": first, "label": label, "mask": np.ones(n, np.float32)},
                        {"image": image, "label": label, "mask": np.ones(n, np.float32)}]

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 2

    def __iter__(self):
        return iter(self.batches)


def nonfinite(spec: dict, sc: dict) -> dict:
    """``train_epoch`` over :class:`TwoBatches` under ``sc["policy"]``."""
    cfg.TRAIN.NONFINITE = sc["policy"]
    model = model_from(spec, 4, torch.float32).train()
    opt = construct_optimizer(model)
    state = {"step": 0}
    try:
        _, done, rec = trainer.train_epoch(TwoBatches(spec), model, opt, state, 0,
                                           get_logger(), CPU)
    except NonFiniteLossError as e:
        return {"raised": str(e), "state": model.state_dict()}
    return {"raised": None, "done": done, "count": opt.count, "losses": rec["losses"],
            "state": model.state_dict()}


def run_train_model(spec: dict, sc: dict) -> dict:
    """``trainer.train_model`` under ``sc["cfg"]`` with the state in f64 (the
    model cast right after it is built): the epoch records and the last
    epoch checkpoint."""
    cfg.merge_from_list(sc["cfg"])
    return train_model_f64()


def train_model_f64() -> dict:
    build = trainer.build_model_from_cfg
    trainer.build_model_from_cfg = lambda generator=None: build(generator).to(torch.float64)
    records = []
    try:
        trainer.train_model(records)
    finally:
        trainer.build_model_from_cfg = build
    dist.barrier()  # the primary has joined its last commit
    last = os.path.join(cfg.OUT_DIR, "checkpoints", f"ckpt_ep_{cfg.OPTIM.MAX_EPOCH - 1:03d}.pth")
    return {"records": [{k: r.get(k) for k in ("epoch", "losses", "acc1", "eval_images")}
                        for r in records],
            "ckpt": torch.load(last, weights_only=True)}


SCENARIOS = {"lockstep": lockstep, "evaluate": evaluate, "nonfinite": nonfinite,
             "train_model": run_train_model}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    cfg.merge_from_list(spec.get("cfg", []))
    assert dist.setup_distributed("gloo", timeout_s=120)
    out = {}
    for sc in spec["scenarios"]:
        out[sc["name"]] = SCENARIOS[sc["kind"]](spec, sc)
    torch.save(out, os.path.join(spec["out"], f"rank{dist.get_rank()}.pt"))
    dist.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
