"""The optimizer (counterpart of distribuuuu_tpu/utils/optim.py).

``sgd`` is torch-ordered SGD: weight decay added to the gradient before
the momentum trace, Nesterov look-ahead, decay on every parameter
including BN; ``OPTIM.MOMENTUM 0`` is plain SGD. ``adamw`` has decoupled
decay and eps 1e-8. ``OPTIM.MOMENTUM_DTYPE bfloat16`` keeps the SGD trace
in bf16 beside fp32 master weights.

The state is the parameter-shaped moment buffers (the trace, or mu and
nu) plus the step count, and a checkpoint saves exactly that. A step is
one call of the fused update (``ops/cuda/opt_update.update``): one kernel
launch on the card. The learning rate is epoch-granular and set between
steps with :func:`set_lr`, as the JAX package injects it.

What a CUDA graph of the train step reads stays at one address for the
optimizer's life: the moments (a restore copies into them), the static
gradient buffers the step writes (``grads``, each laid out as its
parameter), the leaves' pointer table, and the staged scalar table
(``scal``, one row per step of a fold, written by :meth:`stage` before
each call) with its device row index (``row``). ``count`` is the number
of applied steps and lives on the host: the step's caller adds the
steps a call applied (:meth:`advance`).
"""

from __future__ import annotations

import numpy as np
import torch

from distribuuuu_tpu_torch import graphs
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.ops.cuda import opt_update


class Optimizer:
    """Moment buffers and step count for a list of named parameters."""

    def __init__(self, named_params, hyper: opt_update.Hyper, lr: float,
                 momentum_dtype: torch.dtype | None = None, fold: int = 1):
        """``momentum_dtype`` is the SGD trace's dtype (None: the
        parameter's own, as optax's default); ``fold`` the most steps one
        call stages (``TRAIN.STEPS_PER_CALL``)."""
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.hyper = hyper
        self.lr = float(lr)
        self.count = 0
        body = hyper.body()
        mdt = momentum_dtype if body == "sgd" else None
        self.m = None if body == "sgd_plain" else [
            torch.zeros_like(p, dtype=mdt or p.dtype) for p in self.params
        ]
        self.v = [torch.zeros_like(p) for p in self.params] if body == "adamw" else None
        self.fold = max(1, int(fold))
        self.grads = self.scal = self.row = self._table = None

    def trace_dtype(self) -> torch.dtype:
        return self.m[0].dtype if self.hyper.body() == "sgd" else torch.float32

    def stage(self, k: int = 1) -> None:
        """Write the scalar rows of the next ``k`` steps (counts ``count +
        1`` .. ``count + k``, this learning rate) into the static table,
        ahead of the call that applies them (``graphs.stage``). Makes the
        static buffers at the first call."""
        if k > self.fold:
            raise ValueError(f"{k} steps a call, the optimizer stages at most {self.fold}")
        p0 = self.params[0]
        if self.scal is None:
            self.grads = [torch.empty_like(p) for p in self.params]
            self.scal = torch.zeros((self.fold, len(opt_update.SCALARS)), dtype=p0.dtype,
                                    device=p0.device)
            self.row = torch.zeros((), dtype=torch.int32, device=p0.device)
        graphs.stage(self.scal[:k], opt_update.scalar_rows(
            self.hyper, self.lr, self.count + 1, k, self.trace_dtype(), p0.dtype))

    def apply(self, grads=None, skip: torch.Tensor | None = None) -> None:
        """Apply the staged row ``row`` from ``grads`` (default: the static
        buffers ``grads``) and move ``row`` on; with ``skip`` (a device
        flag) nonzero nothing changes and ``row`` stays. No host read: a
        graph captures it."""
        if grads is None:
            grads = self.grads
            if self._table is None and kernel_tier.use_kernel(self.params[0]):
                self._table = opt_update.leaf_table(self.params, grads, self.m, self.v)
        table = self._table if grads is self.grads else None
        opt_update.update(self.params, grads, self.m, self.v, self.hyper, self.scal,
                          self.row, skip, table)
        self.row += 1 if skip is None else (skip == 0).to(torch.int32)

    def advance(self, n: int) -> None:
        """Count ``n`` applied steps."""
        self.count += int(n)

    def step(self, grads) -> None:
        """Apply one update from ``grads`` (one per parameter, in order),
        eagerly."""
        self.stage(1)
        self.row.zero_()
        self.apply(list(grads))
        self.advance(1)

    def state_dict(self) -> dict:
        return {
            "count": self.count,
            "lr": self.lr,
            "m": None if self.m is None else dict(zip(self.names, self.m)),
            "v": None if self.v is None else dict(zip(self.names, self.v)),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a saved state in, by parameter name; a structure that does
        not match this optimizer raises ``ValueError``."""
        for key, bufs in (("m", self.m), ("v", self.v)):
            saved = sd.get(key)
            if (saved is None) != (bufs is None):
                raise ValueError(f"optimizer state {key!r}: saved "
                                 f"{'none' if saved is None else 'one'}, live "
                                 f"{'none' if bufs is None else 'one'}")
            if bufs is None:
                continue
            if set(saved) != set(self.names):
                raise ValueError(f"optimizer state {key!r} names differ from the model's")
            for name, buf in zip(self.names, bufs):
                src = saved[name]
                src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
                if src.shape != buf.shape:
                    raise ValueError(f"optimizer state {key!r}/{name}: saved "
                                     f"{tuple(src.shape)}, live {tuple(buf.shape)}")
                buf.copy_(src)
        self.count = int(sd["count"])
        self.lr = float(sd.get("lr", self.lr))


def _momentum_dtype() -> torch.dtype | None:
    """``OPTIM.MOMENTUM_DTYPE``: bf16, or None for the parameters' dtype
    (``float32``, the fp32 masters)."""
    mode = cfg.OPTIM.MOMENTUM_DTYPE
    if mode not in ("float32", "bfloat16"):
        raise ValueError(f"OPTIM.MOMENTUM_DTYPE={mode!r}")
    return torch.bfloat16 if mode == "bfloat16" else None


def hyper_from_cfg() -> opt_update.Hyper:
    kind = cfg.OPTIM.OPTIMIZER
    if kind not in opt_update.KINDS:
        raise ValueError(f"OPTIM.OPTIMIZER must be 'sgd' or 'adamw'; got {kind!r}")
    return opt_update.Hyper(
        kind=kind,
        wd=float(cfg.OPTIM.WEIGHT_DECAY),
        mom=float(cfg.OPTIM.MOMENTUM) if kind == "sgd" else 0.0,
        nesterov=bool(cfg.OPTIM.NESTEROV) if kind == "sgd" else False,
        b1=float(cfg.OPTIM.BETA1),
        b2=float(cfg.OPTIM.BETA2),
        eps=1e-8,  # optax.adamw's default, as the JAX package uses it
    )


def construct_optimizer(model: torch.nn.Module) -> Optimizer:
    """The configured optimizer over every parameter of ``model``, at
    ``OPTIM.BASE_LR``."""
    return Optimizer(list(model.named_parameters()), hyper_from_cfg(),
                     cfg.OPTIM.BASE_LR, _momentum_dtype(),
                     fold=max(1, int(cfg.TRAIN.STEPS_PER_CALL)))


def set_lr(optimizer: Optimizer, lr: float) -> Optimizer:
    """Set the learning rate of the following steps."""
    optimizer.lr = float(lr)
    return optimizer
