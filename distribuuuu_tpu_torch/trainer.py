"""Training and evaluation, one card a process (counterpart of
distribuuuu_tpu/trainer.py and the step bodies of
distribuuuu_tpu/parallel/partition/lowering.py).

* :class:`TrainStep`: forward in training mode, cross-entropy, backward,
  the gradients averaged over the processes (``parallel/dist.
  all_reduce_grads``, one collective a bucket), ONE fused optimizer update
  (``ops/cuda/opt_update``), the step's metrics as global means and the
  non-finite guard, decided on the global loss so every process skips or
  raises together; ``TRAIN.STEPS_PER_CALL`` such steps as one CUDA graph
  on the card (``graphs.py``), the same body eagerly on the CPU.
  :func:`train_step` runs it once, eagerly. Metrics stay on the device;
  the epoch loop fetches them at ``PRINT_FREQ``, so calls dispatch back
  to back.
* :func:`train_epoch`: epoch-granular learning rate, the device prefetch
  ring, meters and ETA, the preemption check at every call boundary.
* :func:`validate`: masked sums over the val set (the padded tail counts
  nothing; the sampler's repeats, which pad the shards to one length,
  count as in the JAX package), all-reduced over the processes; on the
  card each eval batch shape is one CUDA graph (:class:`EvalStep`); every
  pointwise conv+BN of a CNN's eval forward (ResNet, RegNet,
  BoTNet, EfficientNet; DenseNet's convs are pre-activation and have
  none) runs the conv-epilogue kernel, a ViT's attention runs the flash kernels
  under ``DEVICE.ATTN_IMPL flash`` (or ``auto`` at 1024 tokens or more),
  whose backward kernels also run in every train step,
  and under ``DISTRIBUUUU_GROUP_CONV=pallas`` a RegNet's stride-1 grouped
  3x3 convs at ≤ 14² run the grouped-conv kernel, forward and dx.
* :func:`train_model` / :func:`test_model`: the loops of ``train_net`` and
  ``test_net``, with epoch checkpoints under manifests, ``best``,
  preemption saves and auto-resume that walks back over broken saves
  (``utils/checkpoint.py``), the ``rollback`` policy, background commits
  (``CHECKPOINT.ASYNC``), concurrent eval (``TRAIN.CONCURRENT_EVAL``) and
  fault injection (``utils/faults.py``), on ImageFolder trees, packed
  shards (``DATA.FORMAT shards``, whose preemption saves hold the
  loader's global cursor: the resumed epoch continues at the exact next
  batch) or ``MODEL.DUMMY_INPUT`` data, in one process or several
  (``torchrun``, Slurm; ``parallel/dist.setup_distributed``).

Telemetry (``telemetry/``, ``utils/jsonlog.py``), as the JAX trainer
writes it: the primary's ``{OUT_DIR}/metrics.jsonl`` (``train`` at each
print window, ``eval``, ``epoch``, one ``timeline`` record a batch under
``TRAIN.TIMELINE``) and every rank's ``{OUT_DIR}/telemetry/rank*.jsonl``
(``wait``/``h2d``/``step`` spans a batch on the ``pipeline`` track, or one
``fold_window`` span a call under ``STEPS_PER_CALL > 1``; graph captures;
the ledger's ``cost.*`` at each label's first call, ``train_step``,
``train_fold``, ``eval_step``; memstats and a registry snapshot each
epoch). A ``step`` span times the host's dispatch of a call (a graph
replay is asynchronous); the metric flush is where the host waits. The
``PROF`` window is a ``torch.profiler`` trace. Both sinks close when
``train_model`` or ``test_model`` returns.

Each process runs on one card: ``cuda:LOCAL_RANK`` under a launch of
several processes, else ``cuda:{SERVE.DEVICE}``, under ``DEVICE.PLATFORM``
``auto``/``cuda`` (raising without CUDA); on the CPU only when asked
(``cpu``, the tests; gloo between processes). BatchNorm's ghost groups are
over the global micro-batch (``models/layers.BatchNorm``); ``MODEL.SYNCBN``
is one group of the whole global micro-batch. ``TRAIN.GRAD_ACCUM_STEPS``
splits each step into micro-batches; ``TRAIN.REMAT`` recomputes the
ResNets' stages 1-2 in the backward. ``MESH`` is resolved against the
number of processes and held to the JAX package's capability rules
(``parallel/partition/topology.py``); under a model or expert axis the
model is placed on this rank's shards (``parallel/partition/specs.
place_model``), the gradients and metrics average over the data group,
the loss adds the MoE blocks' balancing loss (``MODEL.MOE.AUX_WEIGHT``),
dispatch MoE reports ``moe_dropped``, and checkpoints hold full tensors.
What the port does not run raises with its ROADMAP item: ZeRO, the
sequence and pipe axes, a model axis on a CNN, the config keys of
mechanisms it lacks and the fault knobs whose mechanism it does not have.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch import graphs, not_ported, telemetry
from distribuuuu_tpu_torch.asyncplane import committer
from distribuuuu_tpu_torch.asyncplane.evalloop import ConcurrentEval
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.loader import (
    construct_train_loader,
    construct_val_loader,
    device_prefetch,
)
from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.models.layers import DropoutSlot, head_dtype, resolve_dtype
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.parallel import mesh as mesh_lib
from distribuuuu_tpu_torch.parallel.partition import specs, topology
from distribuuuu_tpu_torch.resilience import manifest, supervisor
from distribuuuu_tpu_torch.telemetry import costmodel
from distribuuuu_tpu_torch.telemetry import runtime as telemetry_runtime
from distribuuuu_tpu_torch.telemetry import spans as telemetry_spans
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults, preempt
from distribuuuu_tpu_torch.utils.jsonlog import (
    close_metrics_log,
    metrics_log,
    setup_metrics_log,
    timeline_log,
)
from distribuuuu_tpu_torch.utils.logger import get_logger, setup_logger
from distribuuuu_tpu_torch.utils.meters import AverageMeter, construct_meters
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
    0 when unset). The CNNs take their BN regime (``bn_group``;
    ``TRAIN.REMAT`` only the ResNets); botnet50 its attention grid,
    ``ceil(TRAIN.IM_SIZE / 16)`` squared, and ``DEVICE.ATTN_IMPL``; the
    ViTs, LayerNorm-only, take ``DEVICE.ATTN_IMPL`` and the input size; the
    GPTs take ``LM.SEQ_LEN`` and ``DEVICE.ATTN_IMPL``, where ``auto`` is
    the dense causal region, as in the JAX trainer; the ``*_moe`` archs
    ``MODEL.MOE.*``. The model is built whole, then placed on this
    process's mesh (``parallel/partition/specs.place_model``: the shards of
    a model or expert axis; nothing on one process)."""
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
    if arch.endswith("_moe"):
        moe = cfg.MODEL.MOE
        kwargs.update(moe_experts=int(moe.NUM_EXPERTS), moe_top_k=int(moe.TOP_K),
                      moe_every=int(moe.EVERY), moe_impl=str(moe.IMPL),
                      moe_capacity_factor=float(moe.CAPACITY_FACTOR))
    if arch == "botnet50":
        # each stride-2 op maps n → ceil(n/2): the stride-16 trunk gives
        # ceil(IM_SIZE/16); eval crops to TRAIN.IM_SIZE, so both see it
        fmap = max(1, -(-cfg.TRAIN.IM_SIZE // 16))
        kwargs.update(fmap_size=(fmap, fmap), attn_impl=cfg.DEVICE.ATTN_IMPL)
    if cfg.TRAIN.REMAT and not arch.startswith(RESNETS):
        raise ValueError(
            f"TRAIN.REMAT targets the resnet/resnext/wide_resnet family (stages 1-2 "
            f"rematerialization); {arch!r} does not take the knob")
    if cfg.TRAIN.REMAT:
        kwargs["remat"] = True
    model = build_model(
        arch,
        num_classes=cfg.MODEL.NUM_CLASSES,
        dtype=resolve_dtype(cfg.DEVICE.COMPUTE_DTYPE),
        generator=generator or torch.Generator().manual_seed(int(cfg.RNG_SEED or 0)),
        **kwargs,
    )
    mesh = mesh_lib.current()
    return specs.place_model(model, mesh, specs.table_for(arch, mesh.topology().moe_axis()))


def effective_topk() -> int:
    """TOPK clamped to the class count."""
    return min(cfg.TRAIN.TOPK, cfg.MODEL.NUM_CLASSES)


def check_train_cfg(eval_only: bool = False) -> None:
    """Refuse, before any work (and before joining a process group), what
    the port does not run, and a batch geometry that cannot work."""
    if cfg.DATA.FORMAT not in ("imagefolder", "shards", "tokens"):
        raise ValueError(f"DATA.FORMAT must be imagefolder|shards|tokens, got "
                         f"{cfg.DATA.FORMAT!r}")
    lm = cfg.MODEL.ARCH.startswith("gpt")
    if lm and (cfg.MODEL.DUMMY_INPUT or cfg.DATA.FORMAT != "tokens"):
        raise ValueError(f"MODEL.ARCH={cfg.MODEL.ARCH!r} trains and evaluates on token shards: "
                         "set DATA.FORMAT tokens (config/gpt_nano.yaml does) and "
                         "MODEL.DUMMY_INPUT False")
    if not lm and cfg.DATA.FORMAT == "tokens":
        raise ValueError(f"DATA.FORMAT tokens feeds the gpt_* archs, not {cfg.MODEL.ARCH!r}")
    topo = topology_from_cfg()
    check_unported_cfg()
    if topo.model > 1 or topo.expert > 1:
        if cfg.TRAIN.CONCURRENT_EVAL:
            raise not_ported("TRAIN.CONCURRENT_EVAL under a model or expert axis (the eval "
                             "thread's collectives would interleave with the step's on the "
                             "same groups)", PARALLEL)
    if not eval_only:
        supervisor.validate_policy(str(cfg.TRAIN.NONFINITE))
    faults.validate_cfg(cfg.DEVICE.PLATFORM)
    if cfg.MODEL.PRETRAINED and not cfg.MODEL.WEIGHTS:
        raise pretrained_refusal(cfg.MODEL.ARCH)
    if not eval_only:
        check_batch_geometry(topo.data)


def topology_from_cfg() -> topology.Topology:
    """``MESH`` resolved against the number of processes (one card a
    process) and validated by the capability rules; what the port does not
    run raises ``not_ported`` (``parallel/partition/topology.from_cfg``)."""
    world, m = dist.env_world_size(), cfg.MESH
    try:
        return topology.from_cfg(cfg, world)
    except topology.TopologyError:
        raise
    except ValueError as e:
        raise ValueError(
            f"MESH.DATA={m.DATA} MODEL={m.MODEL} SEQ={m.SEQ} PIPE={m.PIPE} EXPERT={m.EXPERT}: "
            f"the port runs one card a process, so the axes multiply to the number of "
            f"processes ({world}), -1 on one axis taking the rest ({e})") from None


# keys of the JAX config whose mechanism the port does not have yet, refused
# away from their defaults -> the ROADMAP item that holds them
UNPORTED_KEYS = {
    "ZERO.OVERLAP": PARALLEL,
    "ZERO.GATHER_AHEAD": PARALLEL,
    "ASYNC.SEQUENCER": "Async, resilience, live plane, shards and analysis",
    "ASYNC.RING_DEADLINE_S": "Async, resilience, live plane, shards and analysis",
    "ASYNC.BARRIER_TIMEOUT_S": "Async, resilience, live plane, shards and analysis",
}


def check_unported_cfg() -> None:
    """``not_ported`` for a key of :data:`UNPORTED_KEYS` set away from its
    default (``MESH.ZERO`` is refused by the topology)."""
    from distribuuuu_tpu_torch.config import _CFG_DEFAULT

    for key, item in UNPORTED_KEYS.items():
        node, leaf = key.split(".")
        if cfg[node][leaf] != _CFG_DEFAULT[node][leaf]:
            raise not_ported(f"{key}={cfg[node][leaf]!r}", item)


def check_batch_geometry(world: int) -> None:
    """The batch geometry, checked before any work as the JAX package's
    ``check_batch_geometry`` does: a process's batch (``TRAIN.BATCH_SIZE``)
    divides into ``TRAIN.GRAD_ACCUM_STEPS`` micro-batches, and the ghost-BN
    group divides the global micro-batch (a process's micro-batch ×
    ``world``, the data axis's size). In the port a group must also divide
    a process's micro-batch or be whole ones."""
    accum = max(1, int(cfg.TRAIN.GRAD_ACCUM_STEPS))
    n = cfg.TRAIN.BATCH_SIZE
    if n % accum:
        raise ValueError(f"TRAIN.BATCH_SIZE={n} per process, not divisible by "
                         f"TRAIN.GRAD_ACCUM_STEPS={accum}")
    micro = n // accum
    total = micro * world
    gs = 0 if cfg.MODEL.ARCH.startswith(("vit", "gpt")) else bn_group_from_cfg()
    if gs > 0 and total > gs:
        if total % gs:
            raise ValueError(
                f"ghost BN group {gs} (MODEL.BN_GROUP, 0 → TRAIN.BATCH_SIZE) does not "
                f"divide the per-step forward batch {total}; adjust MODEL.BN_GROUP / "
                "TRAIN.BATCH_SIZE / GRAD_ACCUM_STEPS")
        if micro % gs and gs % micro:
            raise not_ported(f"ghost BN groups of {gs} over per-process batches of {micro} "
                             "(a group that cuts a process's batch)", REAL_DATA)


def apply_backend_flags() -> None:
    """``CUDNN.BENCHMARK``/``DETERMINISTIC`` (or ``DEVICE.DETERMINISTIC``);
    TF32 off when the compute dtype is float32, so f32 means f32."""
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    torch.backends.cudnn.deterministic = bool(cfg.CUDNN.DETERMINISTIC
                                              or cfg.DEVICE.DETERMINISTIC)
    if cfg.DEVICE.COMPUTE_DTYPE == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def step_graphed(device: torch.device) -> bool:
    """Whether the train and eval steps on ``device`` run as CUDA graphs:
    on the card, with no process group or an NCCL one. A gloo group
    holding CUDA tensors (two ranks sharing one card) cannot be captured:
    its steps run eagerly, by the group's backend, decided before the
    first step (the site's shape, not a fallback on a failed capture)."""
    return graphs.graphed(device) and dist.capturable()


def prep_images(images: torch.Tensor) -> torch.Tensor:
    """The device half of ``DATA.DEVICE_NORMALIZE``: uint8 batches are
    normalized on the device; float batches arrive normalized; int32
    token batches (the LM) pass as they are."""
    if images.dtype == torch.uint8 and cfg.DATA.DEVICE_NORMALIZE:
        return normalize_on_device(images)
    return images


class _StepBody:
    """What a train step's graph reads (the model, the optimizer, the
    staged poison scale and dropout slots, the BN snapshot), kept apart
    from the :class:`TrainStep` that holds the graphs: a body closes over
    this, so no reference cycle runs through a graph (``graphs.py``)."""

    def __init__(self, model, opt, topk: int, accum: int, slots: list, poison, skip: bool):
        self.model, self.opt, self.topk, self.accum = model, opt, topk, accum
        self.slots, self.poison = slots, poison
        self.bufs = list(model.buffers())
        self.snap = [torch.empty_like(b) for b in self.bufs] if skip else None
        self.moe = model.moe_layers() if hasattr(model, "moe_layers") else []
        self.aux_weight = float(cfg.MODEL.MOE.AUX_WEIGHT)
        self.dispatch = [m for m in self.moe if m.ep is not None and m.impl == "dispatch"]
        # the gradients and metrics average over the data group under a
        # model or expert axis (its other ranks hold the same values),
        # over every process otherwise
        mesh = mesh_lib.current()
        self.group = mesh.group("data") if mesh.sharded() else None
        self.reduce = not mesh.sharded()

    def loss(self, logits, labels) -> torch.Tensor:
        """Cross-entropy plus ``MODEL.MOE.AUX_WEIGHT`` times the mean of the
        MoE blocks' balancing losses (JAX ``lowering.loss_fn``)."""
        loss = cross_entropy(logits, labels)
        if self.moe and self.aux_weight:
            loss = loss + self.aux_weight * sum(m.aux for m in self.moe) / len(self.moe)
        return loss

    def __call__(self, k: int, inputs: dict) -> torch.Tensor:
        self.opt.row.zero_()
        return torch.stack([self.step(s, inputs["image"][s], inputs["label"][s])
                            for s in range(k)])

    def step(self, s: int, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model, opt, accum = self.model, self.opt, self.accum
        n = labels.shape[0]
        if n % accum:
            raise ValueError(f"batch dim {n} not divisible by GRAD_ACCUM_STEPS={accum}")
        mb = n // accum
        if self.snap is not None:
            for b, c in zip(self.bufs, self.snap):
                c.copy_(b)
        gsum, micro = None, []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            if self.slots:
                model.dropout_key = self.slots[s * accum + i]
            logits = model(prep_images(images[rows]))
            loss = self.loss(logits, labels[rows]) * self.poison[s]
            grads = torch.autograd.grad(loss, opt.params)
            for m in self.moe:  # no autograd graph outlives the step (graph capture)
                m.aux = None
            gsum = list(grads) if gsum is None else [a + g for a, g in zip(gsum, grads)]
            micro.append((loss.detach(), *accuracy(logits.detach(), labels[rows],
                                                   topk=(1, self.topk)),
                          *self.dropped()))
        with torch.no_grad():
            # the fused update walks each leaf's memory: the static buffers
            # are laid out as the parameters
            for buf, g in zip(opt.grads, gsum):
                buf.copy_(g / accum if accum > 1 else g)
        metrics = micro[0] if accum == 1 else [torch.stack(m).mean() for m in zip(*micro)]
        if self.group is not None:
            dist.all_reduce_grads(opt.grads, self.group)
            metrics = dist.scaled_all_reduce(list(metrics), self.group)
        elif self.reduce:  # every process
            dist.all_reduce_grads(opt.grads)
            metrics = dist.scaled_all_reduce(list(metrics))
        loss, acc1, acck, *dropped = metrics
        bad = torch.logical_not(torch.isfinite(loss))
        opt.apply(skip=None if self.snap is None else bad.to(torch.float32))
        if self.snap is not None:
            with torch.no_grad():
                for b, c in zip(self.bufs, self.snap):
                    b.copy_(torch.where(bad, c, b))
        return torch.stack([loss, acc1.to(loss.dtype), acck.to(loss.dtype),
                            bad.to(loss.dtype), *(d.to(loss.dtype) for d in dropped)])

    def dropped(self) -> list:
        """The mean over the dispatch MoE blocks of the fraction of routed
        assignments lost to the capacity (JAX's ``moe_dropped``), as a
        one-element list; empty without such blocks."""
        if not self.dispatch:
            return []
        return [sum(m.dropped for m in self.dispatch) / len(self.dispatch)]


class TrainStep:
    """The train step, ``fold`` optimizer steps a call (``TRAIN.
    STEPS_PER_CALL``, JAX's folded dispatch), as one graph on the card
    (``graphs.StepGraph``; the CPU runs the same body eagerly).

    A call takes ``k`` batches (``fold``, or 1 for the ragged tail of an
    epoch: a second graph of one step), their poison flags and the step
    cursor of the first (JAX's ``state.step``; default the optimizer's
    count), stages what changes per step (the optimizer's scalar rows, the
    poison scale, the dropout masks, keyed by the cursor as JAX folds its
    key by ``state.step``, so a skipped step moves them on), copies the
    batches into the graph's static inputs and runs the body. Each step of
    the body is :func:`train_step`'s: forward in training mode over
    ``accum`` micro-batches (the BN running stats carried from one to the
    next), cross-entropy times the staged poison scale (1.0, or NaN at
    ``FAULTS.NAN_STEP``: ``loss · 1.0`` is ``loss`` bit for bit), the
    gradients summed, divided by ``accum`` and written into the
    optimizer's static buffers in each parameter's layout, all-reduced
    (one collective a bucket), the metrics as global means, the
    non-finite flag of the global loss, and ONE fused update. Under
    ``policy="skip"`` the flag goes to the kernel, which then changes
    nothing, and the BN buffers are restored from the step's snapshot by
    ``torch.where``: JAX's in-graph skip. The body reads nothing on the
    host. Returns the ``[k, 4]`` metrics (loss, top1, topk, nonfinite;
    a fifth column, ``moe_dropped``, with dispatch MoE blocks),
    valid until the next call; under ``skip`` the call reads the flags
    (one sync a call, as the eager step's ``bool(bad)`` was one a step)
    so that ``optimizer.count`` counts applied steps only.

    ``graphed`` defaults to :func:`step_graphed`; False runs the body
    eagerly wherever it is (the eager :func:`train_step`, and the
    yardstick the graph is measured against)."""

    def __init__(self, model, optimizer, topk: int, policy: str = "raise", accum: int = 1,
                 fold: int = 1, device=None, graphed: bool | None = None, pool=None):
        self.opt, self.accum, self.fold = optimizer, accum, fold
        self.device = torch.device(device) if device is not None else optimizer.params[0].device
        self.graphed = step_graphed(self.device) if graphed is None else graphed
        self.slots = ([DropoutSlot() for _ in range(fold * accum)]
                      if hasattr(model, "dropout_key") else [])
        self.poison = torch.ones(fold, dtype=torch.float32, device=self.device)
        self.body = _StepBody(model, optimizer, topk, accum, self.slots, self.poison,
                              policy == "skip")
        self.pool = pool
        self.stream = torch.cuda.Stream(self.device) if self.graphed else None
        self._graphs: dict = {}
        self.last_graph = None  # the graph of the last call (its first-call memory)

    def _build(self, k: int, batch: dict):
        img, lab = batch["image"], batch["label"]
        inputs = {"image": torch.empty((k, *img.shape), dtype=img.dtype, device=img.device),
                  "label": torch.empty((k, *lab.shape), dtype=lab.dtype, device=lab.device)}
        return graphs.StepGraph(functools.partial(self.body, k, inputs), inputs,
                                device=self.device, pool=self.pool, stream=self.stream,
                                graphed=self.graphed)

    def __call__(self, batches: list, poison: list, step: int | None = None) -> torch.Tensor:
        k = len(batches)
        if k not in (1, self.fold):
            raise ValueError(f"a call takes 1 or {self.fold} batches, got {k}")
        opt = self.opt
        step = opt.count if step is None else step
        opt.stage(k)
        graphs.stage(self.poison[:k], np.where(np.asarray(poison, bool), np.nan, 1.0))
        seed = int(cfg.RNG_SEED or 0)
        for j, slot in enumerate(self.slots[:k * self.accum]):
            slot.set_key((seed, step + j // self.accum, j % self.accum))
        key = (k, *((t.shape, t.dtype) for t in (batches[0]["image"], batches[0]["label"])))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._build(k, batches[0])
        for s, b in enumerate(batches):
            g.inputs["image"][s].copy_(b["image"], non_blocking=True)
            g.inputs["label"][s].copy_(b["label"], non_blocking=True)
        self.last_graph = g
        out = g()
        if self.body.snap is not None:
            opt.advance(k - int(out[:, 3].sum()))
        else:
            opt.advance(k)
        return out


def train_step(model, optimizer, batch: dict, topk: int, policy: str = "raise",
               accum: int = 1, poison: bool = False) -> dict:
    """One optimizer step on ``batch`` (device tensors; ``model`` in train
    mode), eagerly: the body of :class:`TrainStep` run once. With ``accum``
    > 1 the batch splits into that many contiguous micro-batches (rows
    ``[i·mb, (i+1)·mb)``), each a forward and backward in turn, the BN
    running stats carried from one to the next; the gradients are summed
    and divided by ``accum``, then all-reduced once and applied in ONE
    fused optimizer update, as the JAX package's ``accum_train_step``.
    ``poison`` multiplies every micro-batch's loss by NaN
    (``FAULTS.NAN_STEP``). Returns the step's metrics as device scalars,
    the means over the micro-batches and the processes: ``loss``,
    ``top1``, ``topk`` and ``nonfinite`` (1.0 when the global loss is
    NaN/Inf). Under ``policy="skip"`` a non-finite step leaves the
    parameters, the optimizer state and the BN running stats as they were
    before its first micro-batch, on every process. A model with dropout
    (``dropout_key``) gets the key ``(RNG_SEED, optimizer.count, i)`` for
    micro-batch i: its masks depend on the run's seed, the step and the
    micro-batch only (``layers.Dropout``)."""
    step = TrainStep(model, optimizer, topk, policy, accum, device=batch["label"].device,
                     graphed=False)
    out = step([batch], [poison])[0]
    return dict(zip(("loss", "top1", "topk", "nonfinite"), out.unbind(0)))


@torch.inference_mode()
def eval_step(model, batch: dict, topk: int) -> dict:
    """Masked sums of one eval batch: ``loss_sum``, ``correct1``,
    ``correctk`` and ``count`` (device scalars; ``model`` in eval mode).
    Per-token logits ``[B, S, V]`` (the LM) count every token of a
    masked-in sequence as one example: ``count`` is ``mask · S``, as in
    the JAX package's eval step."""
    logits = model(prep_images(batch["image"]))
    mask, labels = batch["mask"], batch["label"].long()
    if logits.dim() == 3:
        mask = mask[:, None].expand(labels.shape).reshape(-1)
        logits, labels = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
    logp = F.log_softmax(logits.to(head_dtype(logits.dtype)), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    hits = logits.topk(topk, dim=-1).indices == labels[:, None]
    return {
        "loss_sum": (nll * mask).sum(),
        "correct1": (hits[:, :1].any(dim=1) * mask).sum(),
        "correctk": (hits.any(dim=1) * mask).sum(),
        "count": mask.sum(),
    }


class EvalStep:
    """The eval step as one graph per eval batch shape (``graphs.
    StepGraph``; the CPU runs the body eagerly): :func:`eval_step` over
    static inputs. Made afresh for each :func:`validate`, after the model's
    eval caches (``prepare()``) are built by the first, eager call, and
    freed when that returns (a body holds the model, not this step), before
    ``train()`` drops the caches the graph reads. A call's sums are valid
    until the next call. ``graphed`` defaults to :func:`step_graphed`;
    False runs :func:`eval_step` on the batch itself."""

    def __init__(self, model, topk: int, device, graphed: bool | None = None, pool=None):
        self.model, self.topk, self.device = model, topk, torch.device(device)
        self.graphed = step_graphed(self.device) if graphed is None else graphed
        self.pool = pool
        self.stream = torch.cuda.Stream(self.device) if self.graphed else None
        self._graphs: dict = {}
        self.last_graph = None

    def __call__(self, batch: dict) -> dict:
        if not self.graphed:
            return eval_step(self.model, batch, self.topk)
        key = tuple((k, batch[k].shape, batch[k].dtype) for k in ("image", "label", "mask"))
        g = self._graphs.get(key)
        if g is None:
            inputs = {k: torch.empty_like(batch[k]) for k in ("image", "label", "mask")}
            g = self._graphs[key] = graphs.StepGraph(
                functools.partial(eval_step, self.model, inputs, self.topk), inputs,
                device=self.device, pool=self.pool, stream=self.stream, graphed=True)
        self.last_graph = g
        return g(**{k: batch[k] for k in ("image", "label", "mask")})


class _ProfilerWindow:
    """``torch.profiler`` (CPU and CUDA activities) over train steps
    ``[PROF.START_STEP, START_STEP + NUM_STEPS)`` of the first executed
    epoch (an auto-resumed run profiles its first epoch too), on the
    primary process, as JAX's ``jax.profiler`` window. It opens at the
    first call boundary at or after the start and closes at the first
    one covering the end (a fold's calls are K steps); it synchronises
    the card before it stops, then writes a Chrome trace
    ``{PROF.DIR or OUT_DIR/profile}/trace_ep{E}.json``."""

    def __init__(self, epoch: int, first_epoch: int, device: torch.device):
        self.active = self.started = False
        self.epoch, self.device = epoch, device
        self.enabled = cfg.PROF.ENABLED and epoch == first_epoch and dist.is_primary()
        if self.enabled and cfg.PROF.NUM_STEPS < 1:
            get_logger().warning("PROF.NUM_STEPS=%d < 1; profiling disabled",
                                 cfg.PROF.NUM_STEPS)
            self.enabled = False
        if self.enabled:
            self.trace_dir = cfg.PROF.DIR or os.path.join(cfg.OUT_DIR, "profile")
            self.first = cfg.PROF.START_STEP
            self.last = cfg.PROF.START_STEP + cfg.PROF.NUM_STEPS
            self.path = None

    def begin(self, it: int) -> None:
        if self.enabled and not self.started and it >= self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.active = self.started = True

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the trace holds the steps' device work
        self.prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir, f"trace_ep{self.epoch + 1}.json")
        self.prof.export_chrome_trace(self.path)
        self.active = False
        get_logger().info("profiler trace written to %s", self.path)

    def end(self, it: int) -> None:
        if self.active and it + 1 >= self.last:
            self._stop()

    def finish(self) -> None:
        """The epoch ended first: close the trace anyway, and say so when
        the window never opened."""
        if self.active:
            get_logger().warning("profiler window truncated by epoch end (wanted steps "
                                 "[%d, %d))", self.first, self.last)
            self._stop()
        elif self.enabled and not self.started:
            get_logger().warning("profiler never started: PROF.START_STEP=%d not reached "
                                 "(epoch has fewer batches?): no trace written", self.first)


def _step_spans_on() -> bool:
    return telemetry_spans.enabled() and cfg.TELEMETRY.STEP_SPANS


def _emit_batch_spans(phase: str, epoch: int, batch: int, tl: dict) -> None:
    """One batch's ``wait``/``h2d``/``step`` spans on the ``pipeline``
    track, from the stamps the loop already took (written after every
    interval closed). Every rank writes them."""
    attrs = {"phase": phase, "epoch": epoch, "batch": batch}
    for name, a, b in (("wait", "get0", "get1"), ("h2d", "put0", "put1")):
        if a in tl and b in tl:
            telemetry_spans.emit_span(name, tl[a], tl[b], track="pipeline", **attrs)
    if "step0" in tl and "step1" in tl:
        telemetry_spans.emit_span("step", tl["step0"], tl["step1"], track="pipeline",
                                  n=tl.get("n", 0), **attrs)


def _cost_on(label: str) -> bool:
    """Whether the ledger still has ``label`` to count (the sink open,
    ``TELEMETRY.COSTMODEL`` on)."""
    return (telemetry_spans.enabled() and cfg.TELEMETRY.COSTMODEL
            and not costmodel.seen(label))


def _meta_batch(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}


def _train_work(model, optimizer, batch: dict, topk: int, accum: int):
    """One train step of :class:`TrainStep`'s body for the ledger, on a
    meta copy of ``model`` (``costmodel.meta_copy``): the forward over the
    micro-batches, the loss, the backward, the metrics and the
    optimizer's plain update over meta moments. Collectives move bytes,
    not FLOPs, and are left out; nothing live is touched."""
    from distribuuuu_tpu_torch.ops.cuda import opt_update

    meta = costmodel.meta_copy(model)
    if hasattr(meta, "dropout_key"):
        meta.dropout_key = DropoutSlot()
        meta.dropout_key.key = (0, 0, 0)
    params = [p for _, p in meta.named_parameters()]
    m = None if optimizer.m is None else [torch.empty_like(t, device="meta") for t in optimizer.m]
    v = None if optimizer.v is None else [torch.empty_like(t, device="meta") for t in optimizer.v]
    scal = torch.as_tensor(opt_update.scalar_rows(optimizer.hyper, optimizer.lr, 1, 1,
                                                  optimizer.trace_dtype(), params[0].dtype))
    mb = _meta_batch({"image": batch["image"], "label": batch["label"]})
    n = mb["label"].shape[0] // accum

    def work():
        gsum = None
        for i in range(accum):
            rows = slice(i * n, (i + 1) * n)
            logits = meta(prep_images(mb["image"][rows]))
            loss = cross_entropy(logits, mb["label"][rows])
            grads = torch.autograd.grad(loss, params)
            gsum = list(grads) if gsum is None else [a + g for a, g in zip(gsum, grads)]
            accuracy(logits.detach(), mb["label"][rows], topk=(1, topk))
        with torch.no_grad():
            opt_update.update_plain(params, [g / accum for g in gsum] if accum > 1 else gsum,
                                    m, v, optimizer.hyper, scal)

    return work


def _capture_train_cost(model, optimizer, batch: dict, topk: int, accum: int,
                        device) -> None:
    """The ledger's ``train_step`` (one step, whatever the fold) before the
    first call."""
    if _cost_on("train_step"):
        costmodel.capture_step(_train_work(model, optimizer, batch, topk, accum),
                               label="train_step", phase="train",
                               images=int(batch["label"].shape[0]), device=device,
                               arch=cfg.MODEL.ARCH)


def _eval_work(model, batch: dict, topk: int):
    """One eval step (:func:`eval_step`) on a meta copy of ``model``, its
    eval caches made first (as the graph's warm-up call makes them; a
    replay does not)."""
    meta, mb = costmodel.meta_copy(model), _meta_batch(batch)
    if hasattr(meta, "prepare"):
        with torch.no_grad():
            meta.prepare()
    return lambda: eval_step(meta, mb, topk)


def train_epoch(loader, model, optimizer, state: dict, epoch: int, logger,
                device: torch.device, runner: TrainStep | None = None, first_epoch: int = 0):
    """One epoch. Returns ``(interrupted, batches_done, record)``: with
    ``TRAIN.PREEMPT_SAVE`` a SIGTERM ends the epoch at a call boundary with
    ``interrupted`` True (the next one with one process; with several,
    every process agrees on the flag every 8 calls, one all-reduce, and
    all leave at the same one). ``batches_done`` is the absolute batch
    cursor: when the loader was armed with a restored shards cursor for
    this epoch (``Loader.load_state_dict``), the epoch continues at batch
    ``start_batch`` and the skipped prefix counts. Batches go to
    ``runner`` (:class:`TrainStep`; one is made for the epoch when None)
    ``TRAIN.STEPS_PER_CALL`` at a time, as JAX's folded dispatch: one call
    of K steps, the ragged tail (``num_batches % K``) through the one-step
    graph. Each batch beats the stall watchdog (``TRAIN.STALL_TIMEOUT``)
    and passes the fault hooks (``FAULTS.*``, at the absolute batch)
    first. Metrics are flushed when ``done % PRINT_FREQ < K`` or at the
    end. ``record`` holds the epoch, ``start_batch``, the steps this call
    ran, the step losses, each batch's wait for its host batch
    (``data_wait_s``), the host time at the end of each step's call
    (``step_t``), the (batches done, host time) of each metric flush (each
    waits for the device) and the graph captures the epoch made
    (``captures``). Telemetry (module docstring): each batch's spans and
    timeline record after its call, or one ``fold_window`` span a call
    under a fold; a ``train`` record at each print; the ledger before
    the first call of ``train_step`` (and ``train_fold``'s memory after
    it); the ``PROF`` window when ``epoch`` is ``first_epoch``."""
    lr = get_epoch_lr(epoch)
    set_lr(optimizer, lr)
    loader.set_epoch(epoch)
    model.train()
    num_batches, topk = len(loader), effective_topk()
    start_batch = getattr(loader, "resume_skip", lambda e: 0)(epoch)
    if start_batch and dist.is_primary():
        logger.info("exact mid-epoch resume: continuing epoch %d at batch %d/%d (restored "
                    "global cursor)", epoch + 1, start_batch + 1, num_batches)
    batch_time, data_time, losses, top1, topk_m, progress = construct_meters(
        num_batches, f"Epoch[{epoch + 1}/{cfg.OPTIM.MAX_EPOCH}]", topk)
    policy = str(cfg.TRAIN.NONFINITE)
    accum = max(1, int(cfg.TRAIN.GRAD_ACCUM_STEPS))
    fold = max(1, int(cfg.TRAIN.STEPS_PER_CALL))
    if runner is None:
        runner = TrainStep(model, optimizer, topk, policy, accum, fold, device)
    nan_step = faults.nan_injection_step()
    monitor = supervisor.NonFiniteMonitor(policy, epoch, logger)
    captures0 = graphs.captures
    record = {"epoch": epoch, "start_batch": start_batch, "steps": 0, "flushes": [],
              "losses": [], "data_wait_s": [], "step_t": [], "captures": 0}
    pending, done, calls = [], start_batch, 0
    preempt_every = 1 if dist.get_world_size() == 1 else 8

    moe_dropped = AverageMeter("MoEDrop", ":.4f")  # dispatch MoE only

    def flush():
        for rows in pending:
            for m in rows.tolist():
                m = dict(zip(("loss", "top1", "topk", "nonfinite", "moe_dropped"), m))
                if monitor.observe(m["loss"], m["nonfinite"], done):
                    continue
                losses.update(m["loss"])
                top1.update(m["top1"])
                topk_m.update(m["topk"])
                if "moe_dropped" in m:
                    moe_dropped.update(m["moe_dropped"])
                record["losses"].append(m["loss"])
        pending.clear()
        record["flushes"].append((done, time.perf_counter()))

    heartbeat = supervisor.Heartbeat(cfg.TRAIN.STALL_TIMEOUT, logger)
    prof = _ProfilerWindow(epoch, first_epoch, device)
    emit_spans, primary = _step_spans_on(), dist.is_primary()
    emit_timeline = cfg.TRAIN.TIMELINE and primary and fold == 1
    held = []  # the batches of the call being assembled
    try:
        end = win_start = time.perf_counter()
        for it, batch, tl in device_prefetch(loader, device, cfg.TRAIN.PREFETCH_DEVICE,
                                            cfg.TRAIN.PIN_MEMORY):
            abs_it = start_batch + it  # the loader skipped the resumed prefix
            heartbeat.beat(f"epoch {epoch + 1} batch {abs_it}")
            faults.maybe_stall(epoch, abs_it)  # each a no-op unless FAULTS.ENABLED
            faults.maybe_kill(epoch, abs_it)
            faults.maybe_preempt(epoch, abs_it)
            faults.maybe_recompile(epoch, abs_it, device)
            faults.maybe_slowdown(epoch, abs_it)
            data_time.update(tl["get1"] - tl["get0"])
            record["data_wait_s"].append(tl["get1"] - tl["get0"])
            held.append(batch)
            if len(held) < fold and abs_it + 1 < num_batches:
                continue
            n = len(held)
            calls_of = [held] if n == fold else [[b] for b in held]
            k0 = len(calls_of[0])
            _capture_train_cost(model, optimizer, held[0], topk, accum, device)
            prof.begin(done)
            tl["step0"] = time.perf_counter()
            for part in calls_of:
                k = len(part)
                poison = [state["step"] + s == nan_step for s in range(k)]
                pending.append(runner(part, poison, state["step"]).clone())
                state["step"] += k
            tl["step1"] = time.perf_counter()
            prof.end(done + n - 1)
            costmodel.capture_memory(runner.last_graph, label="train_fold" if k0 > 1 else
                                     "train_step", phase="train", device=device)
            held.clear()
            done += n
            calls += 1
            record["steps"] = done - start_batch
            if emit_spans and fold == 1:
                _emit_batch_spans("train", epoch + 1, abs_it, tl)
            if emit_timeline:
                timeline_log("train", epoch + 1, abs_it, tl.pop("n", 0), **tl)
            if done % cfg.TRAIN.PRINT_FREQ < fold or done == num_batches:
                flush()
                eta = progress.get_eta(
                    done, (num_batches - done) + (cfg.OPTIM.MAX_EPOCH - epoch - 1) * num_batches)
                logger.info("%s  LR %.5f  ETA %s", progress.display(done), lr, eta)
                if primary:
                    extra = {"moe_dropped": moe_dropped.avg} if moe_dropped.count else {}
                    metrics_log("train", epoch=epoch + 1, batch=done, loss=losses.avg,
                                top1=top1.avg, topk=topk_m.avg, lr=lr,
                                batch_time=batch_time.avg, data_time=data_time.avg, **extra)
            now = time.perf_counter()
            record["step_t"].extend([now] * n)
            batch_time.update((now - end) / n, n=n)
            if emit_spans and fold > 1:
                # a fold has no per-step stamps: one span a call of n steps
                telemetry_spans.emit_span("fold_window", win_start, now, track="pipeline",
                                          phase="train", epoch=epoch + 1, batch=done - n, n=n)
            end = win_start = now
            tick = done if fold == 1 else calls
            if (cfg.TRAIN.PREEMPT_SAVE and done < num_batches and tick % preempt_every == 0
                    and preempt.requested_global()):
                flush()
                logger.warning("preemption signaled — leaving epoch %d at batch %d/%d",
                               epoch + 1, done, num_batches)
                prof.finish()
                return True, done, record
        prof.finish()
    finally:
        heartbeat.stop()
        record["captures"] = graphs.captures - captures0
    _log_lm_rate(logger, epoch, record, loader)
    return False, done, record


def _log_lm_rate(logger, epoch: int, record: dict, loader) -> None:
    """For an LM epoch, the train rate in sequences and tokens a second
    over the steps after the epoch's first call (which captures), into
    the log and ``record`` (``seqs_per_s``, ``tokens_per_s``,
    ``step_ms``)."""
    seq = getattr(getattr(loader, "dataset", None), "seq_len", None)
    t = record["step_t"]
    steps = sum(1 for x in t if x > t[0]) if t else 0
    if not seq or not steps:
        return
    span = t[-1] - t[0]
    mesh = mesh_lib.current()
    shards = mesh.size("data") if mesh.sharded() else dist.get_world_size()
    seqs = steps * loader.batch_size * shards
    record.update(seqs_per_s=seqs / span, tokens_per_s=seqs * seq / span,
                  step_ms=span / steps * 1e3)
    logger.info("Epoch[%d] train: %.1f sequences/s, %.0f tokens/s, %.3f ms a step (%d steps "
                "after the first call)", epoch + 1, record["seqs_per_s"],
                record["tokens_per_s"], record["step_ms"], steps)


def log_eval_result(logger, epoch: int, top1: float, topk_acc: float, loss: float,
                    n: int) -> None:
    """The eval summary line and, on the primary, the ``eval`` record
    (the concurrent eval's join writes them from the main thread, in a
    synchronous run's order)."""
    logger.info("Eval[%d]  Loss %.4f  Acc@1 %.3f  Acc@%d %.3f  (%d %s)",
                epoch + 1, loss, top1, effective_topk(), topk_acc, n,
                "tokens" if cfg.MODEL.ARCH.startswith("gpt") else "samples")
    if dist.is_primary():
        metrics_log("eval", epoch=epoch + 1, loss=loss, top1=top1, topk=topk_acc, samples=n)


def validate(loader, model, epoch: int, logger, device: torch.device,
             watch_preemption: bool | None = None, quiet: bool = False, group=None,
             graphed: bool | None = None, pool=None):
    """The full eval pass over every process's shard: ``(top1, topk, loss,
    samples)`` from the four sums all-reduced over the processes (on
    ``group``, default all), or ``None`` when preemption was signaled
    mid-eval (``TRAIN.PREEMPT_SAVE``). ``quiet`` logs nothing: concurrent
    eval's caller logs the result at the join. On the card each eval batch
    shape is one graph (:class:`EvalStep`, on ``pool``), captured for
    this pass; ``graphed=False`` (concurrent eval, on its own stream over
    a snapshot) runs the step eagerly. Each batch's ``eval`` spans and
    timeline record, and the ledger's ``eval_step`` at the first call."""
    if watch_preemption is None:
        watch_preemption = cfg.TRAIN.PREEMPT_SAVE
    model.eval()
    topk, num_batches, totals = effective_topk(), len(loader), None
    step = EvalStep(model, topk, device, graphed, pool)
    emit_spans = _step_spans_on()
    emit_timeline = cfg.TRAIN.TIMELINE and dist.is_primary()
    end = time.perf_counter()
    for it, batch, tl in device_prefetch(loader, device, cfg.TRAIN.PREFETCH_DEVICE,
                                         cfg.TRAIN.PIN_MEMORY):
        if _cost_on("eval_step"):
            costmodel.capture_step(_eval_work(model, batch, topk), label="eval_step",
                                   phase="eval", images=int(batch["label"].shape[0]),
                                   device=device, arch=cfg.MODEL.ARCH)
        tl["step0"] = time.perf_counter()
        m = step(batch)
        totals = ({k: v.clone() for k, v in m.items()} if totals is None
                  else {k: totals[k] + m[k] for k in totals})
        tl["step1"] = time.perf_counter()
        costmodel.capture_memory(step.last_graph, label="eval_step", phase="eval",
                                 device=device)
        if emit_spans:
            _emit_batch_spans("eval", epoch + 1, it, tl)
        if emit_timeline:
            timeline_log("eval", epoch + 1, it, tl.pop("n", 0), **tl)
        if (it + 1) % cfg.TEST.PRINT_FREQ == 0 and it + 1 < num_batches:
            if watch_preemption and preempt.requested_global():
                logger.warning("preemption signaled — abandoning eval at batch %d/%d",
                               it + 1, num_batches)
                return None
            window = time.perf_counter() - end
            if not quiet:
                logger.info("Eval[%d][%d/%d]  Time %6.3f (%.3f/batch)  Acc@1 %.3f",
                            epoch + 1, it + 1, num_batches, window,
                            window / cfg.TEST.PRINT_FREQ,
                            float(totals["correct1"]) / max(float(totals["count"]), 1.0)
                            * 100)
            end = time.perf_counter()
    keys = sorted(totals)
    vals, mesh = [totals[k] for k in keys], mesh_lib.current()
    if group is None and mesh.sharded():
        # the ranks of one model x expert line evaluated the same batches
        if mesh.size("data") > 1:
            vals = dist.all_reduce_sum(vals, mesh.group("data"))
    else:
        vals = dist.all_reduce_sum(vals, group)
    totals = dict(zip(keys, (float(v) for v in vals)))
    n = max(totals["count"], 1.0)
    top1, topk_acc = totals["correct1"] / n * 100.0, totals["correctk"] / n * 100.0
    loss = totals["loss_sum"] / n
    if not quiet:
        log_eval_result(logger, epoch, top1, topk_acc, loss, int(n))
    return top1, topk_acc, loss, int(n)


def _resume(model, optimizer, state: dict, logger):
    """Load the newest checkpoint that verifies (walking back over broken
    ones, ``utils/checkpoint.find_last_valid_checkpoint``); a checkpoint of
    another arch identity is refused. Returns ``(start_epoch, best_acc1,
    pending_eval, data_state)``: ``data_state`` is the shards cursor a
    preemption save holds, else None."""
    path = ckpt.find_last_valid_checkpoint()
    man = manifest.read_manifest(path)
    if man is not None and man.get("fingerprint") != manifest.config_fingerprint():
        raise ckpt.CheckpointError(
            f"checkpoint {path} cannot feed the configured model: MODEL.ARCH / NUM_CLASSES "
            "/ MOE differ from the checkpoint's; match the config to the save, or start a "
            "fresh OUT_DIR")
    payload = ckpt.load_checkpoint(path)
    specs.load_full_model(model, payload["model"])
    if cfg.TRAIN.LOAD_OPT and "opt" in payload:
        try:
            specs.load_full_opt(model, optimizer, payload["opt"])
        except ValueError as e:
            logger.warning("optimizer state not restored (%s); fresh optimizer", e)
    state["step"] = int(payload.get("step", 0))
    start_epoch = int(payload.get("epoch", -1)) + 1
    logger.info("resumed from %s (epoch %d)", path, start_epoch)
    pending = payload.get("pending_eval")
    ds = payload.get("data_state")
    return (start_epoch, float(payload.get("best_acc1", 0.0)),
            None if pending is None else int(pending),
            None if ds is None else ckpt.decode_data_state(ds))


def _arm_exact_resume(train_loader, data_state, start_epoch: int, logger) -> None:
    """Hand a restored shards cursor (``_resume``'s ``data_state``) to the
    loader, so epoch ``start_epoch`` continues at the exact next batch. A
    cursor of another epoch, or one the live loader refuses (format,
    corpus or order changed), is logged and the epoch re-runs from batch
    0: the resume itself never fails on a cursor."""
    if data_state is None:
        return
    if int(data_state.get("epoch", -1)) != start_epoch:
        logger.warning("saved data cursor is for epoch %s but the resume starts at epoch "
                       "%d: re-running from batch 0", data_state.get("epoch"), start_epoch)
        return
    try:
        skip = train_loader.load_state_dict(data_state)
    except ValueError as e:
        logger.warning("mid-epoch data cursor not restored (%s): re-running epoch %d from "
                       "batch 0", e, start_epoch + 1)
        return
    if dist.is_primary():
        logger.info("restored shards data cursor: epoch %d resumes after %d batches (global "
                    "sample cursor %d)", start_epoch + 1, skip,
                    int(data_state.get("cursor", -1)))


def join_process_group(device: torch.device) -> int:
    """``setup_distributed`` for this process's device (NCCL on the card,
    gloo on the CPU) when the environment launches several processes, and
    the mesh of ``MESH`` over them (``parallel/mesh.setup``: its groups);
    returns the world size."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.setup_distributed("nccl" if device.type == "cuda" else "gloo")
    mesh_lib.setup(topology_from_cfg())
    return dist.get_world_size()


def broadcast_start(model) -> None:
    """Every rank starts from the same weights: the primary's, broadcast
    to all (DDP's start-up broadcast), or under a model or expert axis
    the data group's first rank's to its group (the other ranks of a line
    hold other shards)."""
    mesh = mesh_lib.current()
    if not mesh.sharded():
        dist.broadcast_tensors_from_primary(model.state_dict().values())
    elif mesh.size("data") > 1:
        import torch.distributed as tdist

        src = mesh_lib.rank_of({**mesh.coords, "data": 0}, mesh.sizes)
        for t in model.state_dict().values():
            tdist.broadcast(t, src=src, group=mesh.group("data"))


def train_model(records: list | None = None):
    """End-to-end training (``train_net``). Returns the best Acc@1. Each
    epoch run appends its record (``train_epoch``, plus the decode
    backend, the boundary save's blocking seconds ``save_s`` and the
    eval's wall time, images and Acc@1, which under concurrent eval land
    at its join) to ``records`` when one is given.

    The loop is the JAX package's: under ``TRAIN.NONFINITE rollback`` a
    :class:`~distribuuuu_tpu_torch.resilience.supervisor.NonFiniteLossError`
    joins the concurrent eval and the committer, reloads the last valid
    checkpoint and goes on, ``TRAIN.MAX_ROLLBACKS`` times at most. Under
    ``TRAIN.CONCURRENT_EVAL`` an epoch boundary joins the previous eval
    (its best bookkeeping, the ``best`` side-write from its snapshot),
    saves with ``is_best=False`` and launches this epoch's eval; the last
    eval joins before return. Every exit joins the eval and the committer,
    then closes the telemetry sinks (``metrics.jsonl``, the rank file)."""
    check_train_cfg()
    device = device_from_cfg()
    world = join_process_group(device)
    setup_env()
    logger = setup_logger()
    setup_metrics_log(cfg.OUT_DIR, primary=dist.is_primary())
    # every rank's sink: spans, graph captures, the ledger, registry
    # snapshots, mirrored resilience records
    telemetry.setup_from_cfg(cfg, rank=dist.get_rank())
    try:
        return _train_model(records, device, world, logger)
    finally:
        telemetry.close_telemetry()
        close_metrics_log()


def _train_model(records, device, world: int, logger):
    apply_backend_flags()
    model = build_model_from_cfg(setup_seed()).to(device)
    optimizer = construct_optimizer(model)
    m_params, mb = count_parameters(model)
    logger.info("model %s: %.3fM params (%.2f MB fp32) on %s, %d process(es)",
                cfg.MODEL.ARCH, m_params, mb, device, world)
    graphed = step_graphed(device)
    pool = torch.cuda.graph_pool_handle() if graphed else None
    runner = TrainStep(model, optimizer, effective_topk(), str(cfg.TRAIN.NONFINITE),
                       max(1, int(cfg.TRAIN.GRAD_ACCUM_STEPS)),
                       max(1, int(cfg.TRAIN.STEPS_PER_CALL)), device, graphed, pool)
    if device.type == "cuda":
        logger.info("train and eval steps: %s", "one CUDA graph each, captured at the first "
                    "call and replayed" if graphed else "eager (a gloo group holds CUDA "
                    "tensors: gloo's collectives cannot be captured)")
    train_loader, val_loader = construct_train_loader(), construct_val_loader()
    logger.info("decode backend: %s (DATA.BACKEND %s); %d train and %d val batches of "
                "%d and %d a process", train_loader.backend, cfg.DATA.BACKEND,
                len(train_loader), len(val_loader), train_loader.batch_size,
                val_loader.batch_size)
    # concurrent eval's sums run on a group of their own, made by every
    # process here, in the same order (parallel/dist.side_group)
    eval_group = dist.side_group() if cfg.TRAIN.CONCURRENT_EVAL else None

    state, start_epoch, best_acc1, pending_eval = {"step": 0}, 0, 0.0, None
    resumed = False
    if cfg.TRAIN.AUTO_RESUME and ckpt.has_checkpoint():
        try:
            start_epoch, best_acc1, pending_eval, data_state = _resume(model, optimizer,
                                                                       state, logger)
            _arm_exact_resume(train_loader, data_state, start_epoch, logger)
            resumed = True
        except ckpt.NoValidCheckpointError as e:
            logger.warning("%s — falling through to a fresh start", e)
    if not resumed and cfg.MODEL.PRETRAINED and cfg.MODEL.WEIGHTS:
        load_weights(model, cfg.MODEL.WEIGHTS)
        logger.info("warm-started from pretrained weights %s", cfg.MODEL.WEIGHTS)
    elif not resumed and cfg.MODEL.WEIGHTS:
        logger.warning("MODEL.WEIGHTS is ignored during training unless "
                       "MODEL.PRETRAINED True (evaluation uses test_net)")
    broadcast_start(model)
    if cfg.TRAIN.PREEMPT_SAVE:
        preempt.install()
    by_epoch = {}

    def full_state():
        return {**specs.full_train_state(model, optimizer), "step": state["step"]}

    def preempt_exit(path, resume_epoch):
        committer.join_commits(reason="preemption exit")
        telemetry.emit_snapshot()  # the final counters survive the preemption
        logger.warning("preempted: state saved to %s; rerun to resume at epoch %d",
                       path, resume_epoch + 1)
        return best_acc1

    def save(epoch, is_best):
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(full_state(), epoch, best_acc1, is_best)
        if epoch in by_epoch:
            by_epoch[epoch]["save_s"] = time.perf_counter() - t0
        if dist.is_primary():
            logger.info("saved checkpoint %s%s", path,
                        " (committing in the background)" if cfg.CHECKPOINT.ASYNC else "")

    def finish_epoch(epoch, record):
        """Validate, track the best, save; the preempt path if the eval was
        preempted, else None."""
        nonlocal best_acc1
        t0 = time.perf_counter()
        result = validate(val_loader, model, epoch, logger, device, pool=pool)
        record["eval_wall_s"] = time.perf_counter() - t0
        if result is not None and cfg.MODEL.ARCH.startswith("gpt"):
            logger.info("Eval[%d]: %.0f tokens/s over %.3f s", epoch + 1,
                        result[3] / record["eval_wall_s"], record["eval_wall_s"])
        if result is None:
            return ckpt.save_preempt_checkpoint(full_state(), epoch + 1, best_acc1,
                                                pending_eval=epoch)
        acc1 = result[0]
        record["eval_images"], record["acc1"] = result[3], acc1
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        save(epoch, is_best)
        logger.info("epoch %d done: Acc@1 %.3f (best %.3f)", epoch + 1, acc1, best_acc1)
        if dist.is_primary():
            metrics_log("epoch", epoch=epoch + 1, acc1=acc1, best_acc1=best_acc1)
        return None

    def epoch_telemetry(epoch):
        """At the epoch boundary: the card's memory and a registry
        snapshot on every rank (run_report reads the last)."""
        if not telemetry.enabled():
            return
        if cfg.TELEMETRY.MEMSTATS:
            telemetry_runtime.sample_memstats(device, epoch=epoch + 1)
        telemetry.emit_snapshot(epoch=epoch + 1)

    def timed_eval(snap, epoch):
        t0 = time.perf_counter()
        result = validate(val_loader, snap, epoch, logger, device, watch_preemption=False,
                          quiet=True, group=eval_group, graphed=False)
        return result, time.perf_counter() - t0

    conc_eval = None
    if cfg.TRAIN.CONCURRENT_EVAL:
        conc_eval = ConcurrentEval(timed_eval)
        logger.info("concurrent eval: validate() overlaps the next train epoch on %s; "
                    "results join one boundary later",
                    "its own CUDA stream" if device.type == "cuda" else "a worker thread")

    def join_concurrent_eval():
        """Join the in-flight eval, if any: log it, track the best, and
        side-write ``best`` from the eval's own snapshot."""
        nonlocal best_acc1
        joined = conc_eval.join() if conc_eval is not None else None
        if joined is None:
            return
        ep, (result, wall), snap = joined
        acc1, topk_acc, loss, n = result
        log_eval_result(logger, ep, acc1, topk_acc, loss, n)
        if ep in by_epoch:
            by_epoch[ep].update(eval_wall_s=wall, eval_images=n, acc1=acc1)
        is_best = acc1 > best_acc1
        best_acc1 = max(acc1, best_acc1)
        if is_best:
            ckpt.save_best_checkpoint(snap.state_dict(), ep)
        logger.info("epoch %d done: Acc@1 %.3f (best %.3f)", ep + 1, acc1, best_acc1)
        if dist.is_primary():
            metrics_log("epoch", epoch=ep + 1, acc1=acc1, best_acc1=best_acc1)

    epoch, rollbacks_left = start_epoch, max(0, int(cfg.TRAIN.MAX_ROLLBACKS))
    try:
        if pending_eval is not None:
            logger.info("running epoch %d's validation (skipped by the preemption)",
                        pending_eval + 1)
            path = finish_epoch(pending_eval, {"epoch": pending_eval, "steps": 0})
            if path is not None:
                return preempt_exit(path, pending_eval + 1)
            ckpt.prune_preempts(pending_eval + 1)
        while epoch < cfg.OPTIM.MAX_EPOCH:
            try:
                interrupted, done, record = train_epoch(train_loader, model, optimizer,
                                                        state, epoch, logger, device, runner,
                                                        first_epoch=start_epoch)
            except supervisor.NonFiniteLossError as e:
                if cfg.TRAIN.NONFINITE != "rollback":
                    raise
                if rollbacks_left <= 0:
                    logger.error("rollback budget exhausted (TRAIN.MAX_ROLLBACKS=%d) — the "
                                 "non-finite loss reproduces from the checkpoint; this is "
                                 "not transient corruption", cfg.TRAIN.MAX_ROLLBACKS)
                    raise
                if not ckpt.has_checkpoint():
                    logger.error("non-finite loss before any checkpoint exists — nothing "
                                 "to roll back to")
                    raise
                rollbacks_left -= 1
                logger.warning("non-finite loss at epoch %d batch ~%d — rolling back to the "
                               "last intact checkpoint (%d attempt(s) left)", e.epoch + 1,
                               e.batch, rollbacks_left)
                join_concurrent_eval()
                epoch, best_acc1, rb_pending, rb_ds = _resume(model, optimizer, state,
                                                              logger)
                # rolled back onto a preemption save: honour its cursor too
                _arm_exact_resume(train_loader, rb_ds, epoch, logger)
                if rb_pending is not None:
                    path = finish_epoch(rb_pending, {"epoch": rb_pending, "steps": 0})
                    if path is not None:
                        return preempt_exit(path, rb_pending + 1)
                    ckpt.prune_preempts(rb_pending + 1)
                continue
            record["backend"] = train_loader.backend
            by_epoch[epoch] = record
            if records is not None:
                records.append(record)
            watching = cfg.TRAIN.PREEMPT_SAVE
            if interrupted:
                # the shards format also saves the loader's exact cursor:
                # the rerun continues this epoch at batch `done`
                join_concurrent_eval()
                data_state = (train_loader.state_dict(done) if train_loader.can_save_state()
                              else None)
                return preempt_exit(ckpt.save_preempt_checkpoint(
                    full_state(), epoch, best_acc1, data_state=data_state), epoch)
            if watching and preempt.requested_global():
                join_concurrent_eval()
                path = ckpt.save_preempt_checkpoint(full_state(), epoch + 1, best_acc1,
                                                    pending_eval=epoch)
                return preempt_exit(path, epoch + 1)
            if conc_eval is not None:
                join_concurrent_eval()
                save(epoch, is_best=False)
                conc_eval.launch(model, epoch)
            else:
                path = finish_epoch(epoch, record)
                if path is not None:
                    return preempt_exit(path, epoch + 1)
            epoch_telemetry(epoch)
            if watching and preempt.requested_global():
                join_concurrent_eval()
                return preempt_exit(ckpt.get_checkpoint(epoch), epoch + 1)
            epoch += 1
        join_concurrent_eval()
        committer.join_commits(reason="exit")
        return best_acc1
    finally:
        if conc_eval is not None and conc_eval.in_flight:
            try:
                conc_eval.join()
            except Exception as qe:
                logger.warning("concurrent eval quiesced with error: %s", qe)
        try:
            committer.join_commits()
        except committer.AsyncCommitError as qe:
            logger.warning("async committer quiesced with error: %s", qe)


def test_model():
    """Evaluate ``MODEL.WEIGHTS`` on the val split (``test_net``). Returns
    ``(top1, topk)``, or None when preempted mid-eval."""
    check_train_cfg(eval_only=True)
    device = device_from_cfg()
    join_process_group(device)
    logger = setup_logger()
    setup_metrics_log(cfg.OUT_DIR, primary=dist.is_primary())
    telemetry.setup_from_cfg(cfg, rank=dist.get_rank())
    try:
        return _test_model(device, logger)
    finally:
        telemetry.close_telemetry()
        close_metrics_log()


def _test_model(device, logger):
    apply_backend_flags()
    model = build_model_from_cfg()
    if cfg.MODEL.WEIGHTS:
        load_weights(model, cfg.MODEL.WEIGHTS)
        logger.info("loaded weights from %s", cfg.MODEL.WEIGHTS)
    loader = construct_val_loader()
    logger.info("decode backend: %s (DATA.BACKEND %s)", loader.backend, cfg.DATA.BACKEND)
    result = validate(loader, model.to(device), 0, logger, device)
    telemetry.emit_snapshot()
    if result is None:
        logger.warning("evaluation preempted before completion")
        return None
    logger.info("TEST  Acc@1 %.3f  Acc@%d %.3f", result[0], effective_topk(), result[1])
    return result[0], result[1]
