"""Configuration system of the port.

The port's own copy of the yacs-compatible ``CfgNode`` of
``distribuuuu_tpu/config.py`` (attribute access, ``freeze``/``defrost``,
``merge_from_file``, ``merge_from_list`` with dotted keys, typed merges),
with the part of the default tree that the image configs and the ported
slices use. Every shipped image config (``config/resnet*.yaml`` and the
other CNN and ViT yamls) merges into it unchanged, and so does
``config/gpt_nano.yaml`` (LM, GENERATE, the decode-attention knobs,
DATA.FORMAT). The tree holds every key of the JAX package's, with its
defaults; a key whose mechanism the port does not have yet is accepted at
its default and raises away from it (``trainer.check_unported_cfg``), and
``COMPILE_CACHE`` and ``LOG_DEST`` are inert, as noted where they are
defined.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import yaml

__all__ = ["CfgNode", "cfg", "dump_cfg", "load_cfg_from_args", "merge_from_file",
           "reset_cfg"]


class CfgNode(dict):
    """A dict subclass with attribute access, freezing, and typed merges."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is frozen"
            )
        dict.__setitem__(self, name, value)

    def __setitem__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is frozen"
            )
        dict.__setitem__(self, name, value)

    def is_frozen(self):
        return object.__getattribute__(self, CfgNode._FROZEN)

    def freeze(self):
        self._set_frozen(True)

    def defrost(self):
        self._set_frozen(False)

    def _set_frozen(self, frozen):
        object.__setattr__(self, CfgNode._FROZEN, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(CfgNode(loaded), [])

    def merge_from_other_cfg(self, other):
        self._merge_dict(other, [])

    def merge_from_list(self, cfg_list):
        if len(cfg_list) % 2 != 0:
            raise ValueError(
                f"Override list has odd length: {cfg_list}; it must be (key, value) pairs"
            )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            key_parts = full_key.split(".")
            for sub in key_parts[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub]
            sub = key_parts[-1]
            if sub not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_value(v)
            value = _check_and_coerce(value, d[sub], full_key)
            dict.__setitem__(d, sub, value)

    def _merge_dict(self, other, key_path):
        for k, v in other.items():
            full_key = ".".join(key_path + [str(k)])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full_key}")
            old = self[k]
            if isinstance(old, CfgNode):
                if not isinstance(v, (dict, CfgNode)):
                    raise ValueError(
                        f"Cannot merge non-dict value into config section {full_key}"
                    )
                old._merge_dict(CfgNode(v) if not isinstance(v, CfgNode) else v, key_path + [str(k)])
            else:
                value = _check_and_coerce(copy.deepcopy(v), old, full_key)
                dict.__setitem__(self, k, value)

    def to_dict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self, **kwargs):
        kwargs.setdefault("default_flow_style", None)
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def __repr__(self):
        return f"CfgNode({dict.__repr__(self)})"

    def __str__(self):
        return self.dump()


def _decode_value(v):
    """Parse a CLI string into a Python literal (yaml rules, like yacs)."""
    if not isinstance(v, str):
        return v
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def _check_and_coerce(new, old, full_key):
    """Type-check a replacement value, with yacs-style coercions."""
    old_type, new_type = type(old), type(new)
    if old_type is new_type or old is None or new is None:
        return new
    if isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
        return old_type(new)
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if isinstance(old, int) and isinstance(new, float):
        if float(new).is_integer():
            return int(new)
    raise ValueError(
        f"Type mismatch ({old_type} vs {new_type}) for config key {full_key}: "
        f"cannot replace {old!r} with {new!r}"
    )


# ---------------------------------------------------------------------------
# Default config tree: the reference schema plus the DEVICE / MESH / DATA /
# KERNELS / SERVE additions of distribuuuu_tpu/config.py that the ported
# slices read.
# ---------------------------------------------------------------------------

_C = CfgNode()
cfg = _C

# ------------------------------- model -------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.ARCH = "resnet18"
_C.MODEL.NUM_CLASSES = 1000
# The pretrained URL zoo needs the network: the port refuses it.
_C.MODEL.PRETRAINED = False
# BN statistic regime (training): SYNCBN True = global-batch stats, False =
# ghost groups of BN_GROUP samples (0 = TRAIN.BATCH_SIZE).
_C.MODEL.SYNCBN = False
_C.MODEL.BN_GROUP = 0
# Weights to load (utils/weights.load_weights): a torch .pth / .pth.tar
# state dict, or an orbax checkpoint directory the JAX package saved (a
# weights-only best, a full ckpt_ep_NNN, a sharded save; read without JAX
# by utils/orbax.py, only its params and batch_stats decoded).
_C.MODEL.WEIGHTS = None
_C.MODEL.DUMMY_INPUT = False
_C.MODEL.MOE = CfgNode()
_C.MODEL.MOE.NUM_EXPERTS = 8
_C.MODEL.MOE.TOP_K = 2
_C.MODEL.MOE.EVERY = 2
_C.MODEL.MOE.AUX_WEIGHT = 0.01
# Execution strategy over a populated expert axis (ops/moe.py): "partial"
# = local experts on all tokens + one sum over the axis (exact);
# "dispatch" = switch routing through two all_to_alls at a fixed capacity
# (over-capacity assignments drop: the ``moe_dropped`` train metric). At
# an axis of 1 both run the dense reference formulation.
_C.MODEL.MOE.IMPL = "partial"
# Dispatch capacity: ceil(T_shard * top_k / E * this) slots per expert
# and source rank.
_C.MODEL.MOE.CAPACITY_FACTOR = 2.0

# ------------------------------- training ----------------------------------
_C.TRAIN = CfgNode()
_C.TRAIN.DATASET = "./data/ILSVRC/"
_C.TRAIN.SPLIT = "train"
# Model input size; also the served image size.
_C.TRAIN.IM_SIZE = 224
# Per-process batch size (the reference's per-GPU meaning).
_C.TRAIN.BATCH_SIZE = 32
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.LOAD_OPT = True
# On SIGTERM, leave the epoch at the next step boundary and write a
# mid-epoch checkpoint that AUTO_RESUME prefers (utils/preempt.py).
_C.TRAIN.PREEMPT_SAVE = True
_C.TRAIN.WORKERS = 4
_C.TRAIN.PIN_MEMORY = True
_C.TRAIN.PRINT_FREQ = 30
_C.TRAIN.TOPK = 5
# Optimizer steps per dispatched call: K > 1 runs K steps as one CUDA
# graph (trainer.TrainStep), the ragged tail of an epoch step by step.
_C.TRAIN.STEPS_PER_CALL = 1
# Device prefetch depth (data/loader.device_prefetch): batches k+1..k+N
# are copied host-to-device (pinned, non_blocking) while step k runs.
_C.TRAIN.PREFETCH_DEVICE = 2
# Per-batch kind="timeline" records in the primary's metrics.jsonl (the
# stage stamps of utils/jsonlog.TIMELINE_STAGES); none under
# STEPS_PER_CALL > 1, whose calls are one fold_window span each.
_C.TRAIN.TIMELINE = True
# Rematerialize stages 1-2 of the ResNet family (models/resnet.py):
# their blocks run under torch.utils.checkpoint and are recomputed in the
# backward; parameters, state_dict and the step's math are unchanged.
_C.TRAIN.REMAT = False
# Micro-batches per optimizer step (trainer.train_step): the per-process
# batch is split into GRAD_ACCUM_STEPS contiguous slices, each a forward
# and backward (BN running stats carried from micro to micro), the
# gradients summed and divided by GRAD_ACCUM_STEPS, then one all-reduce
# and one optimizer update. BN ghost groups are over the global
# micro-batch.
_C.TRAIN.GRAD_ACCUM_STEPS = 1
# Non-finite loss policy (resilience/supervisor.py): "raise" fails at the
# next metric flush, "skip" discards the poisoned update and keeps the
# state before the step, "rollback" reloads the last intact checkpoint
# and re-runs from there (MAX_ROLLBACKS attempts).
_C.TRAIN.NONFINITE = "raise"
_C.TRAIN.MAX_ROLLBACKS = 2
# Stall watchdog (resilience/supervisor.Heartbeat): a warning when no
# step lands within STALL_TIMEOUT seconds, or a checkpoint-commit join
# blocks that long. 0 = off (no thread).
_C.TRAIN.STALL_TIMEOUT = 0.0
# Validation overlapped with the next epoch (asyncplane/evalloop.py): a
# snapshot of the model on the card, evaluated on a worker thread and its
# own CUDA stream; the result joins at the next epoch boundary.
_C.TRAIN.CONCURRENT_EVAL = False

# ------------------------------- testing -----------------------------------
_C.TEST = CfgNode()
_C.TEST.DATASET = "./data/ILSVRC/"
_C.TEST.SPLIT = "val"
# Shorter side the val transform resizes to before the center crop.
_C.TEST.IM_SIZE = 256
_C.TEST.BATCH_SIZE = 200
_C.TEST.PRINT_FREQ = 10

# ------------------------------- cudnn --------------------------------------
_C.CUDNN = CfgNode()
_C.CUDNN.BENCHMARK = True
_C.CUDNN.DETERMINISTIC = False

# ------------------------------- optimizer ----------------------------------
_C.OPTIM = CfgNode()
# "sgd" (the reference's recipe) or "adamw" (eps 1e-8).
_C.OPTIM.OPTIMIZER = "sgd"
_C.OPTIM.BETA1 = 0.9
_C.OPTIM.BETA2 = 0.999
_C.OPTIM.BASE_LR = 0.1
_C.OPTIM.LR_POLICY = "cos"
_C.OPTIM.LR_MULT = 0.1
_C.OPTIM.MAX_EPOCH = 100
_C.OPTIM.MOMENTUM = 0.9
_C.OPTIM.DAMPENING = 0.0
_C.OPTIM.NESTEROV = True
_C.OPTIM.WEIGHT_DECAY = 5e-5
_C.OPTIM.WARMUP_FACTOR = 0.1
_C.OPTIM.WARMUP_EPOCHS = 0
_C.OPTIM.STEPS = []
_C.OPTIM.MIN_LR = 0.0
# SGD momentum-buffer dtype: "float32" or "bfloat16" (fp32 master params,
# half-size trace; utils/optim.py).
_C.OPTIM.MOMENTUM_DTYPE = "float32"

# ------------------------------- language model -----------------------------
# The gpt_* archs (models/gpt.py): trained context length, also the size of
# the learned position table, so a prompt plus its new tokens fit under it.
_C.LM = CfgNode()
_C.LM.SEQ_LEN = 256

# -------------------------------- generation --------------------------------
# Autoregressive serving (lm/generate.py): a paged per-request KV cache,
# prefill/decode split, continuous batching over (batch, cache-len) tiles,
# each warmed once at startup.
_C.GENERATE = CfgNode()
# Hard cap on generated tokens per request (requests may ask for fewer).
_C.GENERATE.MAX_NEW_TOKENS = 64
# Concurrent-sequence capacities; the largest is the slot count.
# [] = powers of two up to 4.
_C.GENERATE.BATCH_TILES = []
# KV-cache length tiles; the largest must hold PROMPT_LEN + MAX_NEW_TOKENS,
# each must be <= LM.SEQ_LEN. [] = [LM.SEQ_LEN].
_C.GENERATE.CACHE_TILES = []
# Longest admissible prompt (tokens); prefill pads to a power-of-two tile.
_C.GENERATE.PROMPT_LEN = 64
# Chunked paged prefill: > 0 streams a prompt into its KV-cache page in
# fixed CHUNK_PREFILL-token chunks (one graph a cache tile, in place of the
# prompt tiles), so a prompt may exceed PROMPT_LEN up to what the largest
# cache tile holds next to the request's max_new (+ SPECULATE.K). Every
# cache tile at least CHUNK_PREFILL wide must be a multiple of it. 0 = off.
_C.GENERATE.CHUNK_PREFILL = 0
# Token id that ends a sequence early (the byte tokenizer's EOS);
# -1 = generate exactly max_new_tokens.
_C.GENERATE.EOS_ID = 256
# Scheduler admission poll (seconds) while decode slots are free.
_C.GENERATE.POLL_S = 0.002
# Decode-time token selection: TEMPERATURE 0 is greedy argmax; a sampled
# stream replays from its SEED (counter-based uniforms, lm/generate.py).
_C.GENERATE.SAMPLE = CfgNode()
_C.GENERATE.SAMPLE.TEMPERATURE = 0.0
_C.GENERATE.SAMPLE.TOP_K = 0
_C.GENERATE.SAMPLE.TOP_P = 1.0
_C.GENERATE.SAMPLE.SEED = 0
# Draft-model speculative decoding: the DRAFT_ARCH model (a gpt_* arch; its
# own seeded init, or DRAFT_WEIGHTS, a .pth or an orbax directory) proposes K tokens a round in
# T=1 decode steps, the target verifies all K+1 positions in one call; the
# largest cache tile must hold PROMPT_LEN + MAX_NEW_TOKENS + K.
_C.GENERATE.SPECULATE = CfgNode()
_C.GENERATE.SPECULATE.ENABLED = False
_C.GENERATE.SPECULATE.DRAFT_ARCH = ""
_C.GENERATE.SPECULATE.DRAFT_WEIGHTS = ""
_C.GENERATE.SPECULATE.K = 4

# ------------------------------- kernel tier ---------------------------------
# Hand-written CUDA kernels (ops/cuda/). "auto" is the only value: the
# kernel on CUDA tensors, its plain PyTorch version on CPU tensors.
_C.KERNELS = CfgNode()
# Fused optimizer update (ops/cuda/opt_update.py): one launch per step
# over every parameter, gradient and moment.
_C.KERNELS.OPT_UPDATE = "auto"
# Fused pointwise conv + folded eval BN + activation (ops/cuda/conv_epilogue.py)
# at every 1x1/s1 ungrouped conv+BN site of the eval/serve forward.
_C.KERNELS.CONV_EPILOGUE = "auto"
# Decode attention over the paged KV cache (ops/cuda/decode_attn.py): the
# T=1 step of lm/generate's cached attention.
_C.KERNELS.DECODE_ATTN = "auto"
# Key-block height of the TPU decode kernel, kept so that the same cache
# tiles take the kernel as there: each GENERATE.CACHE_TILES entry must be a
# multiple of it or fit in one block, else the step runs the dense region.
_C.KERNELS.DECODE_BLOCK = 128

# ------------------------------- device / mesh -------------------------------
_C.DEVICE = CfgNode()
# "auto" | "cuda" -> cuda:{SERVE.DEVICE}, raising when CUDA is absent;
# "cpu" is the explicit CPU request (tests).
_C.DEVICE.PLATFORM = "auto"
# Compute dtype of the model; parameters stay fp32 and are cast once when
# the serving engine is built.
_C.DEVICE.COMPUTE_DTYPE = "bfloat16"
_C.DEVICE.DETERMINISTIC = False
# ViT attention: "auto" (the flash kernels at >= 1024 tokens, dense below),
# "xla" (dense, fp32 scores), "flash" (ops/cuda/flash_attention.py),
# "blockwise" (the O(L*chunk) online-softmax loop); "ring"/"ulysses" need
# MESH.SEQ > 1, which the port does not run yet.
_C.DEVICE.ATTN_IMPL = "auto"
# Space-to-depth stem: not ported (the port refuses True).
_C.DEVICE.S2D_STEM = False

_C.MESH = CfgNode()
_C.MESH.DATA = -1
_C.MESH.MODEL = 1
_C.MESH.SEQ = 1
_C.MESH.PIPE = 1
# Expert-parallel axis of the *_moe archs: 1 keeps the experts on the model
# axis (the legacy layout), > 1 gives them an axis of their own (dp x tp x
# ep). One process a card: the axes' product is the number of processes
# (parallel/partition/topology.py, parallel/mesh.py).
_C.MESH.EXPERT = 1
_C.MESH.MICROBATCH = 0
# ZeRO stage over the data axis (parallel/zero.py): 0 off; 1 splits the
# optimizer's moments and the gradient mean over the data group (the
# parameters stay replicated, all-gathered after each update); 3 also rests
# the parameters as shards between steps. 2 raises the JAX package's
# TopologyError; at MESH.DATA 1 every stage is stage 0.
_C.MESH.ZERO = 0

# ZeRO collective scheduling, read under MESH.ZERO > 0 (parallel/zero.py).
# GATHER_AHEAD: -1 gathers every stage-3 leaf once at step entry, 0 at each
# use (again in the backward), N >= 1 hoists the first N block groups.
# OVERLAP is accepted and recorded in the zero.schedule record: the port
# joins each collective before the next, so it changes neither values nor
# timing.
_C.ZERO = CfgNode()
_C.ZERO.OVERLAP = True
_C.ZERO.GATHER_AHEAD = -1

# ------------------------------- data ----------------------------------------
_C.DATA = CfgNode()
# Ship uint8 pixels and normalize on the device (data/transforms.
# normalize_on_device); False sends host-normalized float32.
_C.DATA.DEVICE_NORMALIZE = True
# "imagefolder" (TRAIN.DATASET/TEST.DATASET hold <split>/<class>/*.jpg, or
# MODEL.DUMMY_INPUT data); "shards" streams record shards packed by
# `python -m distribuuuu_tpu_torch.data.shards.pack` (data/shards/;
# TRAIN/TEST.DATASET point at the shards root, the directory holding
# <split>/MANIFEST.json): sequential reads from a few large files, a
# (seed, epoch)-only sample order the same at any world size, and exact
# mid-epoch resume (the preemption checkpoint holds the loader's global
# cursor, so a restart continues at the next batch instead of re-running
# the epoch). "tokens" (the LM's token shards) is not ported to training
# yet.
_C.DATA.FORMAT = "imagefolder"
# The shards' order (data/shards/order.py): storage order cut into
# SHARDS_BLOCK-record sequential runs, the runs permuted, and a
# SHARDS_WINDOW-sample shuffle buffer mixing neighbours. A bigger block
# reads more sequentially and mixes less; a bigger window mixes more and
# scatters the reads. block=1 with window >= the split's size is the
# uniform shuffle of the imagefolder sampler.
_C.DATA.SHARDS_BLOCK = 64
_C.DATA.SHARDS_WINDOW = 1024
# Decode backend: "auto" uses the C++ decoder (native/decode.cc) when it
# builds, else PIL; "native" requires it; "pil" forces pure Python.
_C.DATA.BACKEND = "auto"
# Loader-level resilience (data/loader.py): a failed sample/batch decode
# is retried RETRIES times with exponential backoff starting at
# RETRY_BACKOFF_S (transient filesystem hiccups), then, with SKIP_CORRUPT,
# the corrupt sample is replaced by a good sample from the same batch and
# logged instead of aborting the whole epoch. False restores fail-stop.
_C.DATA.RETRIES = 2
_C.DATA.RETRY_BACKOFF_S = 0.05
_C.DATA.SKIP_CORRUPT = True

# ------------------------------- checkpoints ---------------------------------
_C.CHECKPOINT = CfgNode()
# Background commit of checkpoints (asyncplane/committer.py): the trainer
# blocks for the device-to-host snapshot; the write, the fsync, the
# rename and the manifest (last) run on one daemon thread.
_C.CHECKPOINT.ASYNC = False

# ------------------------------- fault injection -----------------------------
# Deterministic failure injection (utils/faults.py): every hook is one
# attribute read unless ENABLED. The knobs and defaults of the JAX
# package; the ones whose mechanism the port does not have (shards,
# sharded saves, the dispatch sequencer and ring, the cross-host commit
# barrier, recompiles) are refused by faults.validate_cfg with their
# ROADMAP item.
_C.FAULTS = CfgNode()
_C.FAULTS.ENABLED = False
# Multiply the loss by NaN at this global optimizer step: loss and
# gradients go non-finite at exactly that step. -1 = off.
_C.FAULTS.NAN_STEP = -1
# Decode of this dataset sample index raises. "once": the first retry
# succeeds; "always": the loader's skip-and-log path engages. -1 = off.
_C.FAULTS.DECODE_ERROR_IDX = -1
_C.FAULTS.DECODE_ERROR_MODE = "once"
# SIGKILL process KILL_RANK at (KILL_EPOCH, KILL_AT_BATCH). -1 = off.
_C.FAULTS.KILL_RANK = -1
_C.FAULTS.KILL_EPOCH = 0
_C.FAULTS.KILL_AT_BATCH = -1
# Sleep STALL_S seconds at (STALL_EPOCH, STALL_AT_BATCH). -1 = off.
_C.FAULTS.STALL_EPOCH = 0
_C.FAULTS.STALL_AT_BATCH = -1
_C.FAULTS.STALL_S = 0.0
# SIGTERM to this process at (PREEMPT_EPOCH, PREEMPT_AT_BATCH), through
# the installed handler (utils/preempt.py). -1 = off.
_C.FAULTS.PREEMPT_EPOCH = 0
_C.FAULTS.PREEMPT_AT_BATCH = -1
# RECOMPILE_N real CUDA graph captures of trivial bodies at
# (RECOMPILE_EPOCH, RECOMPILE_AT_BATCH), once; the card only. -1 = off.
_C.FAULTS.RECOMPILE_EPOCH = 0
_C.FAULTS.RECOMPILE_AT_BATCH = -1
_C.FAULTS.RECOMPILE_N = 8
# Sleep SLOWDOWN_MS at every batch boundary of SLOWDOWN_EPOCH. 0 = off.
_C.FAULTS.SLOWDOWN_EPOCH = 0
_C.FAULTS.SLOWDOWN_MS = 0.0
# SIGKILL between ckpt_ep_{KILL_MID_ASYNC_SAVE}.pth's rename and its
# manifest: the restart walks back over the manifest-less file. -1 = off.
_C.FAULTS.KILL_MID_ASYNC_SAVE = -1
# Truncate shard file TRUNCATE_SHARD of each split the shards reader opens
# to 60 % of its size (its footer and tail records lost): the reader's
# forward-scan recovery and DATA.SKIP_CORRUPT's substitution. -1 = off.
_C.FAULTS.TRUNCATE_SHARD = -1
# After ckpt_ep_{CORRUPT_EPOCH}.pth commits: "truncate" halves the file,
# "partial" deletes its manifest. -1 = off.
_C.FAULTS.CORRUPT_EPOCH = -1
_C.FAULTS.CORRUPT_MODE = "truncate"
# Refused (the dispatch sequencer and ring, the cross-host commit barrier,
# sharded saves). -1 = off.
_C.FAULTS.WEDGE_DISPATCH = -1
_C.FAULTS.WEDGE_S = 0.0
_C.FAULTS.KILL_AT_COMMIT_BARRIER = -1
_C.FAULTS.WEDGE_RING = -1
_C.FAULTS.WEDGE_RING_S = 0.0
_C.FAULTS.KILL_AT_SHARD_BARRIER = -1
_C.FAULTS.DROP_SHARD_FILE = -1
_C.FAULTS.DROP_SHARD_HOST = 1

# ------------------------------- serving ------------------------------------
_C.SERVE = CfgNode()
# Dynamic micro-batching: flush at MAX_BATCH waiting or MAX_WAIT_MS after
# the oldest request arrived.
_C.SERVE.MAX_BATCH = 8
_C.SERVE.MAX_WAIT_MS = 5.0
# Batch-shape buckets warmed once at startup; [] = powers of two up to
# MAX_BATCH.
_C.SERVE.BUCKET_SIZES = []
# Bounded-queue backpressure.
_C.SERVE.MAX_QUEUE = 64
# CUDA device index of the replica.
_C.SERVE.DEVICE = 0
_C.SERVE.HOST = "127.0.0.1"
_C.SERVE.PORT = 8765
# Weight-only serving quantization (serve/quantize.py): "" (full
# precision), "bf16" or "int8". The engine keeps the packed weights on the
# card and dequantizes them inside every bucket's graph; buckets, protocol
# and batching are unchanged. Tolerances per mode: quantize.TOLERANCE.
_C.SERVE.QUANTIZE = ""
# Length-aware LM admission: prompts of at least LONG_PROMPT_THRESHOLD
# tokens form the "long" class, which may hold at most LONG_MAX_QUEUE of
# the MAX_QUEUE slots (0 = no reservation; a reservation needs a threshold).
_C.SERVE.LONG_PROMPT_THRESHOLD = 0
_C.SERVE.LONG_MAX_QUEUE = 0
# Optional per-length-class windowed p99 SLO targets (ms; 0 = no target):
# the fleet router's `length:short` / `length:long` rows carry them.
_C.SERVE.SHORT_P99_SLO_MS = 0.0
_C.SERVE.LONG_P99_SLO_MS = 0.0
# Request tracing (telemetry/tracectx.py): the fraction of requests a
# client edge opens a trace for (head-based, a pure function of the trace
# id). 0.0 keeps every frame byte-identical to an untraced one.
_C.SERVE.TRACE_SAMPLE = 0.0

# Serving fleet (serve/fleet/, `serve_net --fleet N`): a shared-nothing
# replica pool behind a router process. The router owns SERVE.HOST:PORT;
# each replica is a full serve_net engine in its own process (its own CUDA
# context; several share one card) on an ephemeral port, dispatched to by
# least-loaded policy (router in-flight depth + replica queue depth +
# occupancy + EWMA latency), with idempotent retry on replica failure and
# verbatim backpressure passthrough when the whole fleet is saturated.
_C.SERVE.FLEET = CfgNode()
# Initial replica count (`--fleet N` overrides). The autoscaler moves the
# target inside [MIN_REPLICAS, MAX_REPLICAS]; the pool keeps the target
# met (dead replicas are replaced automatically).
_C.SERVE.FLEET.REPLICAS = 2
_C.SERVE.FLEET.MIN_REPLICAS = 1
_C.SERVE.FLEET.MAX_REPLICAS = 4
# Autoscale-from-telemetry policy loop (fleet/autoscale.py): add a replica
# after BREACH_N consecutive windows with fleet p99 over P99_TARGET_MS or
# total queued work over QUEUE_HIGH; remove one after BREACH_N consecutive
# calm windows (p99 under SCALE_DOWN_FRAC x target AND queue under
# QUEUE_LOW); COOLDOWN_S of hysteresis after every action. False pins the
# fleet at its launch size (the pool still replaces dead replicas).
_C.SERVE.FLEET.AUTOSCALE = True
_C.SERVE.FLEET.P99_TARGET_MS = 250.0
_C.SERVE.FLEET.QUEUE_HIGH = 32
_C.SERVE.FLEET.QUEUE_LOW = 2
_C.SERVE.FLEET.SCALE_DOWN_FRAC = 0.5
_C.SERVE.FLEET.BREACH_N = 3
_C.SERVE.FLEET.EVAL_PERIOD_S = 2.0
_C.SERVE.FLEET.COOLDOWN_S = 10.0
# Replica health-checking (fleet/pool.py): a stats probe every
# HEALTH_PERIOD_S; HEALTH_FAILS consecutive failures (or process exit)
# marks the replica dead, removes it from routing, and spawns its
# replacement. WARMUP_TIMEOUT_S bounds how long a fresh replica may take
# to warm (capture) its bucket shapes before it is abandoned — a replica
# is never routable before its warm-up probe reports every bucket warmed.
_C.SERVE.FLEET.HEALTH_PERIOD_S = 1.0
_C.SERVE.FLEET.HEALTH_FAILS = 3
_C.SERVE.FLEET.WARMUP_TIMEOUT_S = 180.0
# Per-request router->replica socket timeout; a replica that sits on one
# request longer than this is treated as failed (the request reroutes).
_C.SERVE.FLEET.REQUEST_TIMEOUT_S = 60.0
# Fleet telemetry cadence: kind="fleet.stats"/"fleet.replica" records
# into the router's per-rank telemetry sink every EMIT_INTERVAL_S.
_C.SERVE.FLEET.EMIT_INTERVAL_S = 10.0

# ------------------------------- telemetry ----------------------------------
# The telemetry layer (telemetry/): per-rank JSONL files
# ({OUT_DIR}/telemetry/rank*.jsonl: spans, graph captures, registry
# snapshots, mirrored resilience events, the FLOP/byte ledger), read by
# tools/run_report.py into a report and a Perfetto trace. On or off, a run
# trains the same bits and serves the same tokens.
_C.TELEMETRY = CfgNode()
_C.TELEMETRY.ENABLED = True
# Per-rank sink directory; "" = {OUT_DIR}/telemetry.
_C.TELEMETRY.DIR = ""
# Per-batch wait/h2d/step spans on every rank (pipeline track; one
# fold_window span a call under STEPS_PER_CALL > 1) and the loader's
# decode/assemble spans. False keeps the epoch-level records.
_C.TELEMETRY.STEP_SPANS = True
# Each CUDA graph capture as a kind="compile" record and in the
# jit.compiles / jit.compile_s counters.
_C.TELEMETRY.COMPILE_EVENTS = True
# torch.cuda.memory_stats of the card once an epoch (kind="memstats"; a
# CPU run has none).
_C.TELEMETRY.MEMSTATS = True
# The FLOP/byte ledger (telemetry/costmodel.py): once per step label, the
# step's aten ops counted on the meta device (kind="cost.step" and
# "cost.roofline").
_C.TELEMETRY.COSTMODEL = True
# And the graph's measured first-call peak against the card's capacity
# (kind="cost.memory": headroom %). A CPU run has none.
_C.TELEMETRY.COSTMODEL_MEMORY = True

# ------------------------------- profiler -----------------------------------
# torch.profiler (CPU and CUDA activities) over train steps
# [START_STEP, START_STEP + NUM_STEPS) of the first executed epoch, on the
# primary process; a Chrome trace under {OUT_DIR}/profile (or DIR).
_C.PROF = CfgNode()
_C.PROF.ENABLED = False
_C.PROF.DIR = ""
_C.PROF.START_STEP = 10
_C.PROF.NUM_STEPS = 5

# ------------------------------- misc ---------------------------------------
_C.OUT_DIR = "./output"
_C.CFG_DEST = "config.yaml"
_C.RNG_SEED = None
# Read by neither package's logger (both log to stderr and the primary to
# {OUT_DIR}/{time}.log whatever it says): accepted and inert, as in the JAX
# package.
_C.LOG_DEST = "stdout"

# The JAX package's dispatch sequencer, cross-host ring and commit barrier
# (its asyncplane): not ported; a value away from the default raises
# (trainer.check_unported_cfg).
_C.ASYNC = CfgNode()
_C.ASYNC.SEQUENCER = True
_C.ASYNC.BARRIER_TIMEOUT_S = 600.0
_C.ASYNC.RING_DEADLINE_S = 30.0

# XLA's persistent compilation cache has no counterpart: the port's
# compiled artifacts are the nvcc builds, cached by source hash in
# _build/ (ops/cuda/_build.py), and CUDA graphs are captured in each
# process. Accepted and inert.
_C.COMPILE_CACHE = CfgNode()
_C.COMPILE_CACHE.ENABLED = False
_C.COMPILE_CACHE.DIR = ""
_C.COMPILE_CACHE.MIN_COMPILE_TIME_S = 0.0
_C.COMPILE_CACHE.MAX_SIZE_MB = 0

_CFG_DEFAULT = _C.clone()
_CFG_DEFAULT.freeze()


def merge_from_file(cfg_file):
    """Merge a YAML file into the global cfg."""
    _C.merge_from_file(cfg_file)


def dump_cfg() -> str:
    """Write the merged config to ``OUT_DIR/CFG_DEST``; returns the path."""
    os.makedirs(_C.OUT_DIR, exist_ok=True)
    path = os.path.join(_C.OUT_DIR, _C.CFG_DEST)
    with open(path, "w") as f:
        f.write(_C.dump())
    return path


def load_cfg_from_args(description: str = "Config file options.", argv=None):
    """``--cfg path.yaml`` plus dotted ``KEY VALUE`` overrides (the JAX
    package's ``load_cfg_fom_args``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", dest="cfg_file", required=True, type=str,
                        help="Config file location")
    parser.add_argument("opts", help="See distribuuuu_tpu_torch/config.py for all options",
                        default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    merge_from_file(args.cfg_file)
    _C.merge_from_list(args.opts)
    return _C


def reset_cfg():
    """Reset the global cfg back to defaults."""
    _C.defrost()
    _C.merge_from_other_cfg(_CFG_DEFAULT)
