"""Tensor parallelism and the collectives of the sharded layers
(counterpart of distribuuuu_tpu/parallel/tp.py).

The JAX package annotates every Dense kernel ``[in, out]`` as column-
parallel, ``P(None, "model")``, and GSPMD derives the collectives. Here a
column-parallel ``Linear`` (``models/vit.Linear`` with a :class:`Shard`)
holds its rank's rows of the weight (torch's ``[out, in]``), computes its
output columns and all-gathers them on the feature dim over the model
group, so every rank holds the whole, replicated activation between layers
and each output element is the same sum as the unsharded layer's. Two
autograd Functions make the gradients those of the unsharded layer:

* :func:`enter` on the input: identity forward, the backward sums the
  input gradient over the group (each rank's local columns give only
  their share of it);
* :func:`gather` on the output: the backward takes this rank's slice of
  the incoming gradient, with no collective. Everything downstream is
  replicated over the group, so that gradient is already whole on every
  rank.

The MoE layer (``ops/moe.py``) adds :func:`reduce_out` (the sum of the
expert partials: its backward is the identity, since the cotangent arrives
whole on every expert rank), :func:`all_to_all` (its own transpose) and
:func:`data_mean` (the balancing statistics' mean over the data group;
identity backward, see its docstring). Every Function passes a meta tensor
through with the right shape and no collective, so the FLOP ledger
(``telemetry/costmodel.py``) can run a sharded model on the meta device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as tdist
import torch.nn.functional as F


@dataclass(frozen=True)
class Shard:
    """Where a tensor is split: over ``group`` (``size`` ranks, this one at
    ``index``), on dim ``dim``."""

    group: object
    index: int
    size: int
    dim: int = 0

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t``."""
        n = t.shape[self.dim]
        if n % self.size:
            raise ValueError(f"dim {self.dim} of {tuple(t.shape)} does not split over "
                             f"{self.size} ranks")
        k = n // self.size
        return t.narrow(self.dim, self.index * k, k)

    def __deepcopy__(self, memo):
        return self  # a process group is a handle, shared by copies


def _all_gather_cat(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    if x.is_meta:
        shape = list(x.shape)
        shape[dim] *= size
        return torch.empty(shape, dtype=x.dtype, device="meta")
    parts = [torch.empty_like(x) for _ in range(size)]
    tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    if not x.is_meta:
        tdist.all_reduce(x, group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size, dim):
        ctx.index, ctx.k, ctx.dim = index, x.shape[dim], dim
        return _all_gather_cat(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k).contiguous(),
                None, None, None, None)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if not x.is_meta:
        tdist.all_to_all_single(out, x, group=group)
    return out


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        return _all_reduce(x, group) / size

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return x if group is None else _Enter.apply(x, group)


def gather(x: torch.Tensor, shard: Shard | None, dim: int = -1) -> torch.Tensor:
    """All-gather ``dim`` (default the last) over the shard's group, in
    rank order; the backward takes this rank's slice."""
    if shard is None or shard.size == 1:
        return x
    return _Gather.apply(x, shard.group, shard.index, shard.size, dim % x.dim())


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, shard: Shard | None = None,
           bias_sharded: bool = False) -> torch.Tensor:
    """``F.linear``, column-parallel under ``shard``: ``w`` holds this
    rank's output rows, the output columns are all-gathered, and the bias
    is this rank's slice (``bias_sharded``, added before the gather) or
    whole (added after it). Either way each output element is the
    unsharded layer's sum, bit for bit."""
    if shard is None:
        return F.linear(x, w, b)
    x = enter(x, shard.group)
    if bias_sharded:
        return gather(F.linear(x, w, b), shard)
    return gather(F.linear(x, w), shard) + b


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the backward is the identity."""
    return x if group is None else _ReduceOut.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk p of dim 0 goes to rank p of ``group``; chunk s of the result
    came from rank s. Its own transpose."""
    return x if group is None else _AllToAll.apply(x, group)


def data_mean(x: torch.Tensor, data: Shard | None) -> torch.Tensor:
    """The mean over the data group of a per-shard token mean (the MoE
    balancing vectors), as the global-batch mean. The backward is the
    identity, not 1/size: every rank adds the same global term to its
    loss and the gradients are then averaged over the data group, so a
    rank must carry its shard's whole share of the global term's
    gradient (1/size of it by the chain rule, times size)."""
    return x if data is None else _DataMean.apply(x, data.group, data.size)
