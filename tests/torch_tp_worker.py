"""One rank of the port's tensor- and expert-parallel tests
(tests/test_torch_moe.py, tests/test_torch_tp_ep.py): ``python
tests/torch_tp_worker.py SPEC.json`` under ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. It joins a gloo group on the
CPU, runs each scenario of the spec and writes ``{out}/rank{r}.pt``. It
imports no JAX: the tests hold what it writes against the JAX package and
against the port's own unsharded run."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distribuuuu_tpu_torch import config as tconfig  # noqa: E402
from distribuuuu_tpu_torch import trainer  # noqa: E402
from distribuuuu_tpu_torch.config import cfg  # noqa: E402
from distribuuuu_tpu_torch.ops import moe  # noqa: E402
from distribuuuu_tpu_torch.parallel import dist, tp  # noqa: E402
from distribuuuu_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from distribuuuu_tpu_torch.parallel.partition import specs  # noqa: E402
from distribuuuu_tpu_torch.utils.optim import construct_optimizer  # noqa: E402


def moe_ops(spec: dict, sc: dict) -> dict:
    """The partial and dispatch strategies over every rank as one expert
    group, at f64: each run's output, dropped fraction and the gradients
    of ``Σ out · dy`` with respect to the gate, the input and this rank's
    expert tensors."""
    import torch.distributed as tdist

    data = torch.load(sc["data"], weights_only=True)
    rank, world = dist.get_rank(), dist.get_world_size()
    ep = tp.Shard(tdist.group.WORLD, rank, world)
    out = {}
    for name, impl, cf in sc["runs"]:
        params = {k: (ep.take(v) if k != "gate" else v).clone().requires_grad_(True)
                  for k, v in data["params"].items()}
        x = data["x"].clone().requires_grad_(True)
        if impl == "partial":
            y, dropped = moe.moe_ffn_partial(params, x, ep, sc["top_k"]), None
        else:
            y, dropped = moe.moe_ffn_dispatch(params, x, ep, sc["top_k"], cf)
        (y * data["dy"]).sum().backward()
        out[name] = {"out": y.detach(), "dropped": None if dropped is None else float(dropped),
                     "grads": {"x": x.grad, **{k: v.grad for k, v in params.items()}}}
    return out


def _setup(sc: dict):
    tconfig.reset_cfg()
    tconfig.merge_from_file(sc["yaml"])
    cfg.merge_from_list(sc["opts"])
    mesh = mesh_lib.setup(trainer.topology_from_cfg())
    model = trainer.build_model_from_cfg()
    specs.load_full_model(model, torch.load(sc["weights"], weights_only=True))
    return mesh, model.to(torch.float64).train()


def lockstep(spec: dict, sc: dict) -> dict:
    """``steps`` f64 train steps of the configured stanza from the full
    weights ``weights``, each rank on its data shard of each global batch:
    the losses, each MoE block's balancing loss of the first step, the
    full state after the last step (rank 0) and this rank's shard shapes."""
    mesh, model = _setup(sc)
    opt = construct_optimizer(model)
    batches = torch.load(sc["batches"], weights_only=True)
    d, n_data = mesh.data_coords()
    losses, aux = [], None
    for b in batches:
        n = b["image"].shape[0] // n_data
        part = {k: v[d * n:(d + 1) * n] for k, v in b.items()}
        if aux is None:  # the step drops each layer's aux after its backward
            with torch.no_grad():
                model(trainer.prep_images(part["image"]))
            aux = [float(m.aux) for m in model.moe_layers()]
        losses.append(float(trainer.train_step(model, opt, part, 5)["loss"]))
    full = specs.full_train_state(model, opt)
    return {"losses": losses, "aux": aux, "coords": mesh.coords,
            "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "state": full if dist.is_primary() else None}


def train_model(spec: dict, sc: dict) -> dict:
    """``trainer.train_model`` under the stanza with the state in f64 (the
    model cast after it is built and placed)."""
    tconfig.reset_cfg()
    tconfig.merge_from_file(sc["yaml"])
    cfg.merge_from_list(sc["opts"])
    build = trainer.build_model_from_cfg
    trainer.build_model_from_cfg = lambda generator=None: build(generator).to(torch.float64)
    records = []
    try:
        trainer.train_model(records)
    finally:
        trainer.build_model_from_cfg = build
    return {"losses": [r["losses"] for r in records]}


SCENARIOS = {"moe_ops": moe_ops, "lockstep": lockstep, "train_model": train_model}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    np.random.seed(0)
    assert dist.setup_distributed("gloo", timeout_s=120)
    out = {}
    for sc in spec["scenarios"]:
        out[sc["name"]] = SCENARIOS[sc["kind"]](spec, sc)
        mesh_lib.reset()
    torch.save(out, os.path.join(spec["out"], f"rank{dist.get_rank()}.pt"))
    dist.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
