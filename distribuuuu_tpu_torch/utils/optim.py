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
"""

from __future__ import annotations

import numpy as np
import torch

from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.ops.cuda import opt_update


class Optimizer:
    """Moment buffers and step count for a list of named parameters."""

    def __init__(self, named_params, hyper: opt_update.Hyper, lr: float,
                 momentum_dtype: torch.dtype | None = None):
        """``momentum_dtype`` is the SGD trace's dtype (None: the
        parameter's own, as optax's default)."""
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

    def step(self, grads) -> None:
        """Apply one update from ``grads`` (one per parameter, in order)."""
        self.count += 1
        opt_update.update(self.params, grads, self.m, self.v, self.hyper, self.lr,
                          self.count)

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
                     cfg.OPTIM.BASE_LR, _momentum_dtype())


def set_lr(optimizer: Optimizer, lr: float) -> Optimizer:
    """Set the learning rate of the following steps."""
    optimizer.lr = float(lr)
    return optimizer
