"""One rank of the port's ZeRO tests (tests/test_torch_zero_ranks.py):
``python tests/torch_zero_worker.py SPEC.json`` under ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. It joins a gloo group on the
CPU, runs each scenario of the spec and writes ``{out}/rank{r}.pt``. It
imports no JAX: the tests hold what it writes against the port's stage-0
run, its one-process run and the JAX package."""

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
from distribuuuu_tpu_torch.parallel import dist, zero  # noqa: E402
from distribuuuu_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from distribuuuu_tpu_torch.parallel.partition import specs  # noqa: E402
from distribuuuu_tpu_torch.utils.optim import construct_optimizer  # noqa: E402


def _cfg(sc: dict) -> None:
    tconfig.reset_cfg()
    tconfig.merge_from_file(sc["yaml"])
    cfg.merge_from_list(sc["opts"])


def lockstep(spec: dict, sc: dict) -> dict:
    """``steps`` train steps (``sc["dtype"]``) of the configured stanza
    from the full weights ``weights``, each rank on its data shard of each
    global batch: the losses, the data-axis all-gathers of each step, the
    resting bytes between steps, the eval sums of the last state, and the
    full state after the last step (rank 0)."""
    _cfg(sc)
    dtype = getattr(torch, sc.get("dtype", "float64"))
    trainer.check_train_cfg()
    mesh = mesh_lib.setup(trainer.topology_from_cfg())
    model = trainer.build_model_from_cfg()
    specs.load_full_model(model, torch.load(sc["weights"], weights_only=True))
    model = model.to(dtype).train()
    opt = construct_optimizer(model)
    rt = opt.zero
    if rt is not None:
        rt.rest(model)
    batches = torch.load(sc["batches"], weights_only=True)
    d, n_data = mesh.data_coords()
    step = trainer.TrainStep(model, opt, 5, str(cfg.TRAIN.NONFINITE),
                             max(1, int(cfg.TRAIN.GRAD_ACCUM_STEPS)), graphed=False)
    losses, gathers, resting = [], [], []
    for b in batches:
        n = b["label"].shape[0] // n_data
        part = {k: v[d * n:(d + 1) * n] for k, v in b.items()}
        if part["image"].is_floating_point():
            part["image"] = part["image"].to(dtype)
        g0 = dist.zero_gathers.count
        losses.append(float(step([part], [False])[0, 0]))
        gathers.append(dist.zero_gathers.count - g0)
        resting.append(zero.resting_bytes(opt))
    with zero.gathered(model):
        full = zero.kept(specs.full_train_state(model, opt), model)
        model.eval()
        ev = b if "eval" not in sc else torch.load(sc["eval"], weights_only=True)
        n = ev["label"].shape[0] // n_data
        part = {k: v[d * n:(d + 1) * n] for k, v in ev.items()}
        if part["image"].is_floating_point():
            part["image"] = part["image"].to(dtype)
        part.setdefault("mask", torch.ones(n, dtype=dtype))
        g0 = dist.zero_gathers.count
        sums = {k: float(v) for k, v in trainer.eval_step(model, part, 5).items()}
    eval_gathers = dist.zero_gathers.count - g0
    plan = rt.plan if rt is not None else None
    zdims = [None] * len(opt.params) if plan is None else rt.zdims
    predicted = zero.predict_resting_bytes(
        [tuple(p.shape) for p in opt.params], zdims, n_data, int(cfg.MESH.ZERO),
        opt.params[0].element_size(),
        [bufs[0].element_size() for bufs in (opt.m, opt.v) if bufs])
    return {"losses": losses, "predicted": predicted, "gathers": gathers, "resting": resting,
            "eval": sums, "eval_gathers": eval_gathers, "coords": mesh.coords,
            "sharded": 0 if plan is None else len(plan.sharded()),
            "leaves": len(opt.params),
            "bound": None if plan is None else zero.gather_bound(plan, cfg.ZERO.GATHER_AHEAD),
            "zdims": None if plan is None else {leaf.name: leaf.zdim for leaf in plan.leaves},
            "moment_shapes": {n: tuple(t.shape) for n, t in zip(opt.names, opt.m or [])},
            "state": full if dist.is_primary() else None}


def train_model(spec: dict, sc: dict) -> dict:
    """``trainer.train_model`` under the stanza, the model cast to
    ``sc["dtype"]`` after it is built and placed (``dummy``: that many
    dummy samples a split in place of ``BATCH_SIZE × 64``): the losses of
    every epoch run."""
    from distribuuuu_tpu_torch.data import loader
    from distribuuuu_tpu_torch.data.dummy import DummyDataset

    _cfg(sc)
    dtype = getattr(torch, sc.get("dtype", "float64"))
    build, dataset = trainer.build_model_from_cfg, loader._build_dataset
    trainer.build_model_from_cfg = lambda generator=None: build(generator).to(dtype)
    if sc.get("dummy"):
        loader._build_dataset = lambda train: DummyDataset(sc["dummy"], cfg.TRAIN.IM_SIZE,
                                                           raw_u8=True)
    records = []
    try:
        trainer.train_model(records)
    finally:
        trainer.build_model_from_cfg, loader._build_dataset = build, dataset
    return {"losses": [r["losses"] for r in records], "epochs": [r["epoch"] for r in records]}


SCENARIOS = {"lockstep": lockstep, "train_model": train_model}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    import faulthandler
    faulthandler.enable()
    np.random.seed(0)
    assert dist.setup_distributed("gloo", timeout_s=120)
    out = {}
    for sc in spec["scenarios"]:
        try:
            out[sc["name"]] = SCENARIOS[sc["kind"]](spec, sc)
        except Exception as e:  # a drill's expected failure is the result
            if not sc.get("expect_error"):
                raise
            out[sc["name"]] = {"error": f"{type(e).__name__}: {e}"}
        mesh_lib.reset()
    torch.save(out, os.path.join(spec["out"], f"rank{dist.get_rank()}.pt"))
    dist.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
