"""Training and evaluation, one card a process (counterpart of
distribuuuu_tpu/trainer.py and the step bodies of
distribuuuu_tpu/parallel/partition/lowering.py).

* :func:`train_step`: forward in training mode, cross-entropy, backward,
  the gradients averaged over the processes (``parallel/dist.
  all_reduce_grads``, one collective a bucket), ONE fused optimizer update
  (``ops/cuda/opt_update``), the step's metrics as global means and the
  non-finite guard, decided on the global loss so every process skips or
  raises together. Metrics stay on the device; the epoch loop fetches
  them at ``PRINT_FREQ``, so steps dispatch back to back.
* :func:`train_epoch`: epoch-granular learning rate, the device prefetch
  ring, meters and ETA, the preemption check at every step boundary.
* :func:`validate`: masked sums over the val set (the padded tail counts
  nothing; the sampler's repeats, which pad the shards to one length,
  count as in the JAX package), all-reduced over the processes; on the
  card every pointwise conv of a ResNet's or RegNet's eval forward runs
  the conv-epilogue kernel, a ViT's attention runs the flash kernels
  under ``DEVICE.ATTN_IMPL flash`` (or ``auto`` at 1024 tokens or more),
  whose backward kernels also run in every train step,
  and under ``DISTRIBUUUU_GROUP_CONV=pallas`` a RegNet's stride-1 grouped
  3x3 convs at ≤ 14² run the grouped-conv kernel, forward and dx.
* :func:`train_model` / :func:`test_model`: the loops of ``train_net`` and
  ``test_net``, with epoch checkpoints, ``best``, preemption saves and
  auto-resume (``utils/checkpoint.py``), on ImageFolder trees or
  ``MODEL.DUMMY_INPUT`` data, in one process or several
  (``torchrun``, Slurm; ``parallel/dist.setup_distributed``).

Each process runs on one card: ``cuda:LOCAL_RANK`` under a launch of
several processes, else ``cuda:{SERVE.DEVICE}``, under ``DEVICE.PLATFORM``
``auto``/``cuda`` (raising without CUDA); on the CPU only when asked
(``cpu``, the tests; gloo between processes). BatchNorm's ghost groups are
over the global batch (``models/layers.BatchNorm``); ``MODEL.SYNCBN`` is
one group of the whole global batch. What the port does not run raises
with its ROADMAP item: mesh axes beyond data, folded steps, gradient
accumulation, rematerialization, concurrent eval, fault injection,
asynchronous checkpoints and the ``rollback`` policy.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.loader import (
    construct_train_loader,
    construct_val_loader,
    device_prefetch,
)
from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.models.layers import head_dtype, resolve_dtype
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.ops.cuda import opt_update
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.resilience import supervisor
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import preempt
from distribuuuu_tpu_torch.utils.logger import setup_logger
from distribuuuu_tpu_torch.utils.meters import construct_meters
from distribuuuu_tpu_torch.utils.metrics import accuracy, count_parameters, cross_entropy
from distribuuuu_tpu_torch.utils.optim import construct_optimizer, set_lr
from distribuuuu_tpu_torch.utils.schedules import get_epoch_lr
from distribuuuu_tpu_torch.utils.seed import setup_env, setup_seed
from distribuuuu_tpu_torch.utils.weights import load_weights, pretrained_refusal

REAL_DATA = "Real data and many processes"
PARALLEL = "Parallel layouts beyond DP"


def bn_group_from_cfg() -> int:
    """BN statistic regime: ``SYNCBN True`` ⇒ 0 (global-batch stats);
    else ghost groups of ``MODEL.BN_GROUP``, defaulting to
    ``TRAIN.BATCH_SIZE``."""
    if cfg.MODEL.SYNCBN:
        return 0
    return cfg.MODEL.BN_GROUP or cfg.TRAIN.BATCH_SIZE


def device_from_cfg() -> torch.device:
    """``DEVICE.PLATFORM`` ``auto``/``cuda`` → ``cuda:LOCAL_RANK`` under a
    launch of several processes, else ``cuda:{SERVE.DEVICE}``; raises when
    CUDA is absent. ``cpu`` is the explicit CPU request."""
    platform = cfg.DEVICE.PLATFORM
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("auto", "cuda"):
        raise ValueError(
            f"DEVICE.PLATFORM={platform!r}: the port runs on 'auto' or 'cuda' "
            "(the card) or 'cpu' (tests)"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"DEVICE.PLATFORM={platform!r} needs a CUDA device and torch sees "
            "none; pass DEVICE.PLATFORM cpu to run on the CPU on purpose"
        )
    several = dist.env_world_size() > 1
    idx = dist.get_local_rank() if several else int(cfg.SERVE.DEVICE)
    if not 0 <= idx < torch.cuda.device_count():
        raise ValueError(
            f"{'LOCAL_RANK' if several else 'SERVE.DEVICE'}={idx} out of range: "
            f"{torch.cuda.device_count()} CUDA devices"
        )
    return torch.device("cuda", idx)


RESNETS = ("resnet", "resnext", "wide_resnet")


def attn_impl_from_cfg() -> str:
    """``DEVICE.ATTN_IMPL`` for the ViT and GPT archs, as the JAX trainer
    routes it: ``auto``/``xla``/``flash``/``blockwise`` on one device;
    ``ring``/``ulysses`` need a sequence-sharded mesh (``MESH.SEQ > 1``),
    which the port does not have yet."""
    impl = cfg.DEVICE.ATTN_IMPL
    if cfg.MESH.SEQ > 1:
        raise not_ported(f"sequence-sharded attention (MESH.SEQ={cfg.MESH.SEQ})",
                         "Parallel layouts beyond DP")
    if impl in ("ring", "ulysses"):
        raise ValueError(f"DEVICE.ATTN_IMPL={impl!r} needs a sequence-sharded mesh: set "
                         "MESH.SEQ > 1")
    if impl not in ("auto", "xla", "flash", "blockwise"):
        raise ValueError(f"DEVICE.ATTN_IMPL={impl!r}: ViT archs accept 'auto', 'xla' "
                         "(dense), 'flash' (the flash kernels), 'blockwise', or MESH.SEQ>1 "
                         "for ring attention; GPT archs the same")
    return impl


def build_model_from_cfg(generator: torch.Generator | None = None):
    """The configured arch on the CPU, in fp32 master weights, filled by
    ``generator`` (default: a ``torch.Generator`` seeded with ``RNG_SEED``,
    0 when unset). The CNNs (ResNets, RegNets) take their BN regime
    (``bn_group``; ``TRAIN.REMAT`` only the ResNets); the ViTs,
    LayerNorm-only, take ``DEVICE.ATTN_IMPL`` and the input size; the
    GPTs take ``LM.SEQ_LEN`` and ``DEVICE.ATTN_IMPL``, where ``auto`` is
    the dense causal region, as in the JAX trainer."""
    kernel_tier.validate_kernels_cfg(cfg.KERNELS)
    if cfg.DEVICE.S2D_STEM:
        raise not_ported("DEVICE.S2D_STEM (space-to-depth stem)", "S2D stem")
    arch = cfg.MODEL.ARCH
    kwargs = {}
    if arch.startswith("vit"):
        kwargs.update(attn_impl=attn_impl_from_cfg(), img_size=cfg.TRAIN.IM_SIZE)
    elif arch.startswith("gpt"):
        impl = attn_impl_from_cfg()
        kwargs.update(attn_impl="xla" if impl == "auto" else impl,
                      seq_len=int(cfg.LM.SEQ_LEN))
    else:
        kwargs["bn_group"] = bn_group_from_cfg()
    if cfg.TRAIN.REMAT and not arch.startswith(RESNETS):
        raise ValueError(
            f"TRAIN.REMAT targets the resnet/resnext/wide_resnet family (stages 1-2 "
            f"rematerialization); {arch!r} does not take the knob")
    return build_model(
        arch,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dtype=resolve_dtype(cfg.DEVICE.COMPUTE_DTYPE),
        generator=generator or torch.Generator().manual_seed(int(cfg.RNG_SEED or 0)),
        **kwargs,
    )


def effective_topk() -> int:
    """TOPK clamped to the class count."""
    return min(cfg.TRAIN.TOPK, cfg.MODEL.NUM_CLASSES)


def check_train_cfg(eval_only: bool = False) -> None:
    """Refuse, before any work (and before joining a process group), what
    the port does not run, and a batch geometry that cannot work."""
    if cfg.MODEL.ARCH.startswith("gpt"):
        raise not_ported(f"training or evaluating {cfg.MODEL.ARCH!r} (token shards, the "
                         "per-token loss)", "LM plane")
    if cfg.DATA.FORMAT != "imagefolder":
        raise not_ported(f"DATA.FORMAT={cfg.DATA.FORMAT!r}", REAL_DATA)
    world, mesh = dist.env_world_size(), cfg.MESH
    if mesh.MODEL != 1 or mesh.SEQ != 1 or mesh.PIPE != 1:
        raise not_ported(f"MESH axes beyond data (MODEL={mesh.MODEL}, SEQ={mesh.SEQ}, "
                         f"PIPE={mesh.PIPE})", PARALLEL)
    if mesh.DATA not in (-1, world):
        raise ValueError(f"MESH.DATA={mesh.DATA}: the port runs one card a process, so the "
                         f"data axis is -1 or the number of processes ({world})")
    refusals = [(bool(cfg.FAULTS.ENABLED), "FAULTS.ENABLED (fault injection)")]
    if not eval_only:
        refusals += [
            (cfg.TRAIN.STEPS_PER_CALL > 1,
             f"TRAIN.STEPS_PER_CALL={cfg.TRAIN.STEPS_PER_CALL} (folded steps)"),
            (cfg.TRAIN.GRAD_ACCUM_STEPS > 1,
             f"TRAIN.GRAD_ACCUM_STEPS={cfg.TRAIN.GRAD_ACCUM_STEPS} (gradient accumulation)"),
            (bool(cfg.TRAIN.REMAT) and cfg.MODEL.ARCH.startswith(RESNETS),
             "TRAIN.REMAT (rematerialized stages)"),
            (bool(cfg.TRAIN.CONCURRENT_EVAL), "TRAIN.CONCURRENT_EVAL"),
            (bool(cfg.CHECKPOINT.ASYNC), "CHECKPOINT.ASYNC (background checkpoint commits)"),
        ]
        supervisor.validate_policy(str(cfg.TRAIN.NONFINITE))
    for refused, what in refusals:
        if refused:
            raise not_ported(what, REAL_DATA)
    if cfg.MODEL.PRETRAINED and not cfg.MODEL.WEIGHTS:
        raise pretrained_refusal(cfg.MODEL.ARCH)
    if not eval_only:
        check_batch_geometry(world)


def check_batch_geometry(world: int) -> None:
    """The ghost-BN geometry over the global batch (``TRAIN.BATCH_SIZE``
    a process × ``world``), checked before any work as the JAX package's
    ``check_batch_geometry`` does. A group must divide the global batch,
    and in the port it must also divide a process's batch or be whole
    process batches."""
    n = cfg.TRAIN.BATCH_SIZE
    total = n * world
    gs = 0 if cfg.MODEL.ARCH.startswith(("vit", "gpt")) else bn_group_from_cfg()
    if gs > 0 and total > gs:
        if total % gs:
            raise ValueError(
                f"ghost BN group {gs} (MODEL.BN_GROUP, 0 → TRAIN.BATCH_SIZE) does not "
                f"divide the per-step forward batch {total}; adjust MODEL.BN_GROUP / "
                "TRAIN.BATCH_SIZE")
        if n % gs and gs % n:
            raise not_ported(f"ghost BN groups of {gs} over per-process batches of {n} (a "
                             "group that cuts a process's batch)", REAL_DATA)


def apply_backend_flags() -> None:
    """``CUDNN.BENCHMARK``/``DETERMINISTIC`` (or ``DEVICE.DETERMINISTIC``);
    TF32 off when the compute dtype is float32, so f32 means f32."""
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC
                                              or cfg.DEVICE.DETERMINISTIC)
    if cfg.DEVICE.COMPUTE_DTYPE == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def prep_images(images: torch.Tensor) -> torch.Tensor:
    """The device half of ``DATA.DEVICE_NORMALIZE``: uint8 batches are
    normalized on the device; float batches arrive normalized."""
    if images.dtype == torch.uint8 and cfg.DATA.DEVICE_NORMALIZE:
        return normalize_on_device(images)
    return images


def train_step(model, optimizer, batch: dict, topk: int, policy: str = "raise") -> dict:
    """One optimizer step on ``batch`` (device tensors; ``model`` in train
    mode). Returns the step's metrics as device scalars, means over the
    processes: ``loss``, ``top1``, ``topk`` and ``nonfinite`` (1.0 when the
    global loss is NaN/Inf). Under ``policy="skip"`` a non-finite step
    leaves the parameters, the optimizer state and the BN running stats as
    they were, on every process."""
    labels = batch["label"]
    saved = ([b.clone() for b in model.buffers()] if policy == "skip" else None)
    logits = model(prep_images(batch["image"]))
    loss = cross_entropy(logits, labels)
    # the fused update walks each leaf's memory: a gradient laid out
    # unlike its parameter is copied into the parameter's layout
    grads = [g if opt_update.same_layout(g, p) else torch.empty_like(p).copy_(g)
             for g, p in zip(torch.autograd.grad(loss, optimizer.params), optimizer.params)]
    dist.all_reduce_grads(grads)
    loss = loss.detach()
    acc1, acck = accuracy(logits.detach(), labels, topk=(1, topk))
    loss, acc1, acck = dist.scaled_all_reduce([loss, acc1, acck])
    bad = torch.logical_not(torch.isfinite(loss))
    if saved is not None and bool(bad):
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
    else:
        optimizer.step(grads)
    return {"loss": loss, "top1": acc1, "topk": acck, "nonfinite": bad.float()}


@torch.inference_mode()
def eval_step(model, batch: dict, topk: int) -> dict:
    """Masked sums of one eval batch: ``loss_sum``, ``correct1``,
    ``correctk`` and ``count`` (device scalars; ``model`` in eval mode)."""
    logits = model(prep_images(batch["image"]))
    mask, labels = batch["mask"], batch["label"].long()
    logp = F.log_softmax(logits.to(head_dtype(logits.dtype)), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    hits = logits.topk(topk, dim=-1).indices == labels[:, None]
    return {
        "loss_sum": (nll * mask).sum(),
        "correct1": (hits[:, :1].any(dim=1) * mask).sum(),
        "correctk": (hits.any(dim=1) * mask).sum(),
        "count": mask.sum(),
    }


def train_epoch(loader, model, optimizer, state: dict, epoch: int, logger,
                device: torch.device):
    """One epoch. Returns ``(interrupted, batches_done, record)``: with
    ``TRAIN.PREEMPT_SAVE`` a SIGTERM ends the epoch at a step boundary with
    ``interrupted`` True (the next one with one process; with several,
    every process agrees on the flag every 8 steps, one all-reduce, and
    all leave at the same step). ``record`` holds the epoch, its steps,
    the step losses, each step's wait for its host batch (``data_wait_s``)
    and the (steps done, host time) of each metric flush; every flush
    waits for the device."""
    lr = get_epoch_lr(epoch)
    set_lr(optimizer, lr)
    loader.set_epoch(epoch)
    model.train()
    num_batches, topk = len(loader), effective_topk()
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        num_batches, f"Epoch[{epoch + 1}/{cfg.OPTIM.MAX_EPOCH}]", topk)
    policy = str(cfg.TRAIN.NONFINITE)
    monitor = supervisor.NonFiniteMonitor(policy, epoch, logger)
    record = {"epoch": epoch, "steps": 0, "flushes": [], "losses": [], "data_wait_s": []}
    pending, done = [], 0
    preempt_every = 1 if dist.get_world_size() == 1 else 8

    def flush():
        for m in pending:
            m = {k: float(v) for k, v in m.items()}
            if monitor.observe(m["loss"], m["nonfinite"], done):
                continue
            losses.update(m["loss"])
            top1.update(m["top1"])
            topk_m.update(m["topk"])
            record["losses"].append(m["loss"])
        pending.clear()
        record["flushes"].append((done, time.perf_counter()))

    end = time.perf_counter()
    for _, batch, tl in device_prefetch(loader, device, cfg.TRAIN.PREFETCH_DEVICE,
                                        cfg.TRAIN.PIN_MEMORY):
        data_time.update(tl["get1"] - tl["get0"])
        record["data_wait_s"].append(tl["get1"] - tl["get0"])
        pending.append(train_step(model, optimizer, batch, topk, policy))
        state["step"] += 1
        done += 1
        record["steps"] = done
        batch_time.update(time.perf_counter() - end)
        end = time.perf_counter()
        if done % cfg.TRAIN.PRINT_FREQ == 0 or done == num_batches:
            flush()
            eta = progress.get_eta(
                done, (num_batches - done) + (cfg.OPTIM.MAX_EPOCH - epoch - 1) * num_batches)
            logger.info("%s  LR %.5f  ETA %s", progress.display(done), lr, eta)
        if (cfg.TRAIN.PREEMPT_SAVE and done < num_batches and done % preempt_every == 0
                and preempt.requested_global()):
            flush()
            logger.warning("preemption signaled — leaving epoch %d at batch %d/%d",
                           epoch + 1, done, num_batches)
            return True, done, record
    return False, done, record


def validate(loader, model, epoch: int, logger, device: torch.device,
             watch_preemption: bool | None = None):
    """The full eval pass over every process's shard: ``(top1, topk, loss,
    samples)`` from the four sums all-reduced over the processes, or
    ``None`` when preemption was signaled mid-eval
    (``TRAIN.PREEMPT_SAVE``)."""
    if watch_preemption is None:
        watch_preemption = cfg.TRAIN.PREEMPT_SAVE
    model.eval()
    topk, num_batches, totals = effective_topk(), len(loader), None
    end = time.perf_counter()
    for it, batch, _ in device_prefetch(loader, device, cfg.TRAIN.PREFETCH_DEVICE,
                                        cfg.TRAIN.PIN_MEMORY):
        m = eval_step(model, batch, topk)
        totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
        if (it + 1) % cfg.TEST.PRINT_FREQ == 0 and it + 1 < num_batches:
            if watch_preemption and preempt.requested_global():
                logger.warning("preemption signaled — abandoning eval at batch %d/%d",
                               it + 1, num_batches)
                return None
            window = time.perf_counter() - end
            logger.info("Eval[%d][%d/%d]  Time %6.3f (%.3f/batch)  Acc@1 %.3f",
                        epoch + 1, it + 1, num_batches, window,
                        window / cfg.TEST.PRINT_FREQ,
                        float(totals["correct1"]) / max(float(totals["count"]), 1.0) * 100)
            end = time.perf_counter()
    keys = sorted(totals)
    totals = dict(zip(keys, (float(v) for v in
                             dist.all_reduce_sum([totals[k] for k in keys]))))
    n = max(totals["count"], 1.0)
    top1, topk_acc = totals["correct1"] / n * 100.0, totals["correctk"] / n * 100.0
    loss = totals["loss_sum"] / n
    logger.info("Eval[%d]  Loss %.4f  Acc@1 %.3f  Acc@%d %.3f  (%d samples)",
                epoch + 1, loss, top1, topk, topk_acc, int(n))
    return top1, topk_acc, loss, int(n)


def _resume(model, optimizer, state: dict, logger):
    """Load the newest checkpoint; returns ``(start_epoch, best_acc1,
    pending_eval)``."""
    path = ckpt.get_last_checkpoint()
    payload = ckpt.load_checkpoint(path)
    model.load_state_dict(payload["model"])
    if cfg.TRAIN.LOAD_OPT and "opt" in payload:
        try:
            optimizer.load_state_dict(payload["opt"])
        except ValueError as e:
            logger.warning("optimizer state not restored (%s); fresh optimizer", e)
    state["step"] = int(payload.get("step", 0))
    start_epoch = int(payload.get("epoch", -1)) + 1
    logger.info("resumed from %s (epoch %d)", path, start_epoch)
    pending = payload.get("pending_eval")
    return start_epoch, float(payload.get("best_acc1", 0.0)), \
        None if pending is None else int(pending)


def join_process_group(device: torch.device) -> int:
    """``setup_distributed`` for this process's device (NCCL on the card,
    gloo on the CPU) when the environment launches several processes;
    returns the world size."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.setup_distributed("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size()


def train_model(records: list | None = None):
    """End-to-end training (``train_net``). Returns the best Acc@1. Each
    epoch run appends its record (``train_epoch``, plus the decode backend
    and the eval's wall time, images and Acc@1) to ``records`` when one is
    given."""
    check_train_cfg()
    device = device_from_cfg()
    world = join_process_group(device)
    setup_env()
    logger = setup_logger()
    apply_backend_flags()
    model = build_model_from_cfg(setup_seed()).to(device)
    optimizer = construct_optimizer(model)
    m_params, mb = count_parameters(model)
    logger.info("model %s: %.3fM params (%.2f MB fp32) on %s, %d process(es)",
                cfg.MODEL.ARCH, m_params, mb, device, world)
    if cfg.TRAIN.TIMELINE:
        logger.info("TRAIN.TIMELINE and the telemetry sinks: the port writes no "
                    "records yet (ROADMAP.md Queue 1, Telemetry)")
    train_loader, val_loader = construct_train_loader(), construct_val_loader()
    logger.info("decode backend: %s (DATA.BACKEND %s); %d train and %d val batches of "
                "%d and %d a process", train_loader.backend, cfg.DATA.BACKEND,
                len(train_loader), len(val_loader), train_loader.batch_size,
                val_loader.batch_size)

    state, start_epoch, best_acc1, pending_eval = {"step": 0}, 0, 0.0, None
    if cfg.TRAIN.AUTO_RESUME and ckpt.has_checkpoint():
        start_epoch, best_acc1, pending_eval = _resume(model, optimizer, state, logger)
    elif cfg.MODEL.PRETRAINED and cfg.MODEL.WEIGHTS:
        load_weights(model, cfg.MODEL.WEIGHTS)
        logger.info("warm-started from pretrained weights %s", cfg.MODEL.WEIGHTS)
    elif cfg.MODEL.WEIGHTS:
        logger.warning("MODEL.WEIGHTS is ignored during training unless "
                       "MODEL.PRETRAINED True (evaluation uses test_net)")
    dist.broadcast_tensors_from_primary(model.state_dict().values())
    if cfg.TRAIN.PREEMPT_SAVE:
        preempt.install()

    def full_state():
        return {"model": model.state_dict(), "opt": optimizer.state_dict(),
                "step": state["step"]}

    def preempt_exit(path, resume_epoch):
        logger.warning("preempted: state saved to %s; rerun to resume at epoch %d",
                       path, resume_epoch + 1)
        return best_acc1

    def finish_epoch(epoch, record):
        """Validate, track the best, save; the preempt path if the eval was
        preempted, else None."""
        nonlocal best_acc1
        t0 = time.perf_counter()
        result = validate(val_loader, model, epoch, logger, device)
        record["eval_wall_s"] = time.perf_counter() - t0
        if result is None:
            return ckpt.save_preempt_checkpoint(full_state(), epoch + 1, best_acc1,
                                                pending_eval=epoch)
        acc1 = result[0]
        record["eval_images"], record["acc1"] = result[3], acc1
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        path = ckpt.save_checkpoint(full_state(), epoch, best_acc1, is_best)
        logger.info("epoch %d done: Acc@1 %.3f (best %.3f)", epoch + 1, acc1, best_acc1)
        if dist.is_primary():
            logger.info("saved checkpoint %s", path)
        return None

    if pending_eval is not None:
        logger.info("running epoch %d's validation (skipped by the preemption)",
                    pending_eval + 1)
        path = finish_epoch(pending_eval, {"epoch": pending_eval, "steps": 0})
        if path is not None:
            return preempt_exit(path, pending_eval + 1)
        ckpt.prune_preempts(pending_eval + 1)

    for epoch in range(start_epoch, cfg.OPTIM.MAX_EPOCH):
        interrupted, _, record = train_epoch(train_loader, model, optimizer, state, epoch,
                                             logger, device)
        record["backend"] = train_loader.backend
        if records is not None:
            records.append(record)
        if interrupted:
            return preempt_exit(ckpt.save_preempt_checkpoint(full_state(), epoch,
                                                             best_acc1), epoch)
        if cfg.TRAIN.PREEMPT_SAVE and preempt.requested_global():
            path = ckpt.save_preempt_checkpoint(full_state(), epoch + 1, best_acc1,
                                                pending_eval=epoch)
            return preempt_exit(path, epoch + 1)
        path = finish_epoch(epoch, record)
        if path is not None:
            return preempt_exit(path, epoch + 1)
    return best_acc1


def test_model():
    """Evaluate ``MODEL.WEIGHTS`` on the val split (``test_net``). Returns
    ``(top1, topk)``, or None when preempted mid-eval."""
    check_train_cfg(eval_only=True)
    device = device_from_cfg()
    join_process_group(device)
    logger = setup_logger()
    apply_backend_flags()
    model = build_model_from_cfg()
    if cfg.MODEL.WEIGHTS:
        load_weights(model, cfg.MODEL.WEIGHTS)
        logger.info("loaded weights from %s", cfg.MODEL.WEIGHTS)
    loader = construct_val_loader()
    logger.info("decode backend: %s (DATA.BACKEND %s)", loader.backend, cfg.DATA.BACKEND)
    result = validate(loader, model.to(device), 0, logger, device)
    if result is None:
        logger.warning("evaluation preempted before completion")
        return None
    logger.info("TEST  Acc@1 %.3f  Acc@%d %.3f", result[0], effective_topk(), result[1])
    return result[0], result[1]
