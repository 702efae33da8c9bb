"""Mixture-of-experts FFN (counterpart of distribuuuu_tpu/ops/moe.py).

Parameters (a dict of tensors, the JAX layout):
  gate  [d, E]                      (replicated)
  w_in  [E, d, f], b_in  [E, f]     (split over the expert axis, dim 0)
  w_out [E, f, d], b_out [E, d]     (split over the expert axis, dim 0)

Routing is the JAX package's: the router in fp32 (``gating_probs``), top-k
with the lower expert index first on ties (``jax.lax.top_k``; a stable
descending sort here, since ``torch.topk`` promises no order), the k
weights renormalised. Three strategies over the same parameters:

* :func:`moe_ffn_reference`: every expert over every token, weighted by
  a gate that is zero off the top-k: the dense formulation JAX runs at an
  expert axis of 1, and the oracle of the other two;
* :func:`moe_ffn_partial` (``MODEL.MOE.IMPL partial``): a rank runs its
  local experts over all tokens and the partials are summed over the
  expert group. Exact. The sum's backward is the identity (the cotangent
  is whole on every rank). Every rank routes all tokens alike; the experts'
  input and the routing weights are entered through ``tp.enter``, whose
  backward sums their gradients over the group (each rank's experts give
  only their share), so the f32 router's backward sees the whole gradient
  of its weights on every rank and computes the unsharded layer's bits;
* :func:`moe_ffn_dispatch` (``dispatch``): the tokens are split over the
  group, routed to their experts' ranks by ``all_to_all`` at capacity
  ``C = max(1, ceil(ceil(T / n) · k / E · capacity_factor))``, processed,
  sent back and all-gathered. A slot is the running count over (token, k)
  in token-major order, pad tokens take none, and assignments past C drop
  (the returned fraction). The combine adds at most k = 2 terms to zero
  per token, which is the same sum in either order, so the card's atomic
  ``index_add_`` is deterministic here.

The expert matmuls are ``torch.matmul``: the JAX package computes them
outside any Pallas kernel. ``group`` arguments are ``tp.Shard``-like
(``group``, ``index``, ``size``): the expert axis's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from distribuuuu_tpu_torch.models.layers import gelu
from distribuuuu_tpu_torch.parallel import tp

EXPERT_KEYS = ("w_in", "b_in", "w_out", "b_out")


def gating_probs(x: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Router probabilities ``softmax(x @ gate)`` in fp32, ``[T, E]`` (the
    JAX package casts both to fp32 whatever the compute dtype)."""
    return torch.softmax(x.to(torch.float32) @ gate_w.to(torch.float32), dim=-1)


def top_k_indices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The ``top_k`` largest per row, the lower index first among equal
    values (``jax.lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]


def top_k_from_probs(probs: torch.Tensor, top_k: int):
    """``(weights [T, k] f32, indices [T, k] int32)``: the top-k
    probabilities renormalised to sum 1."""
    indices = top_k_indices(probs, top_k)
    weights = probs.gather(-1, indices)
    weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
    return weights, indices.to(torch.int32)


def top_k_gating(x: torch.Tensor, gate_w: torch.Tensor, top_k: int):
    return top_k_from_probs(gating_probs(x, gate_w), top_k)


def balance_stats(probs: torch.Tensor, top_k: int):
    """``f`` [E], the fraction of (token, k) assignments per expert (sums
    to 1), and ``p`` [E], the mean router probability per expert: token
    means, so equal token shards average to the whole batch's exactly."""
    assigned = _one_hot(top_k_indices(probs, top_k), probs.shape[-1]).to(probs.dtype).sum(dim=1)
    return assigned.mean(dim=0) / top_k, probs.mean(dim=0)


def _one_hot(indices: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot`` as a comparison: ``F.one_hot`` checks its indices'
    range on the host, a synchronisation a CUDA graph cannot capture."""
    return indices[..., None] == torch.arange(n, device=indices.device)


def aux_from_balance_stats(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e f_e · p_e``."""
    return f.shape[-1] * torch.sum(f * p)


def load_balancing_loss_from_probs(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The switch-transformer balancing loss (1.0 at a uniform
    assignment)."""
    return aux_from_balance_stats(*balance_stats(probs, top_k))


def _expert_ffn(w_in, b_in, w_out, b_out, x):
    """One expert on ``[T, d]`` tokens: ``gelu(x @ w_in + b_in) @ w_out +
    b_out`` in ``x``'s dtype (tanh GELU, as ``jax.nn.gelu``)."""
    h = gelu(x @ w_in.to(x.dtype) + b_in.to(x.dtype))
    return h @ w_out.to(x.dtype) + b_out.to(x.dtype)


def _weighted_experts(params: dict, x, weights, indices, first: int) -> torch.Tensor:
    """``Σ_le expert(first + le)(x) · w_e`` over the experts ``params``
    holds, in index order (the JAX loop's order)."""
    out = torch.zeros_like(x)
    for le in range(params["w_in"].shape[0]):
        y = _expert_ffn(params["w_in"][le], params["b_in"][le], params["w_out"][le],
                        params["b_out"][le], x)
        w_e = (weights * (indices == first + le)).sum(dim=-1)
        out = out + y * w_e[:, None].to(x.dtype)
    return out


def moe_ffn_reference(params: dict, x: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """Every expert over every ``[T, d]`` token, weighted by its top-k gate
    (0 off the top-k)."""
    weights, indices = top_k_gating(x, params["gate"], top_k)
    return _weighted_experts(params, x, weights, indices, 0)


def moe_ffn_partial(params: dict, x: torch.Tensor, ep, top_k: int = 2) -> torch.Tensor:
    """Exact expert-parallel MoE on ``[T, d]`` tokens replicated over the
    expert group ``ep``: this rank's experts (``params`` holds ``E / n`` of
    them, the whole gate) over all tokens, the partials summed over the
    group."""
    e = params["gate"].shape[-1]
    if e % ep.size:
        raise ValueError(f"expert-axis size {ep.size} must divide num_experts {e}")
    weights, indices = top_k_gating(x, params["gate"], top_k)
    out = _weighted_experts(params, tp.enter(x, ep.group), tp.enter(weights, ep.group),
                            indices, ep.index * params["w_in"].shape[0])
    return tp.reduce_out(out, ep.group)


def _rank_dispatch(params: dict, x: torch.Tensor, valid: torch.Tensor, ep, top_k: int,
                   cap: int):
    """This rank's switch dispatch of its ``[T_local, d]`` token shard
    (``valid`` marks real tokens): ``(out [T_local, d], kept, total)``
    with this rank's surviving and valid (token, k) assignments."""
    e = params["gate"].shape[-1]
    n = ep.size
    local_e = e // n
    t_local, d = x.shape
    weights, indices = top_k_gating(x, params["gate"], top_k)
    flat_e = indices.reshape(-1).long()
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(t_local, device=x.device).repeat_interleave(top_k)
    flat_valid = valid.repeat_interleave(top_k)
    one_hot = (_one_hot(flat_e, e) & flat_valid[:, None]).long()
    pos = (torch.cumsum(one_hot, dim=0) * one_hot - 1).max(dim=-1).values
    keep = (pos >= 0) & (pos < cap)
    slot_e, slot_c = torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)
    vals = torch.where(keep[:, None], x[flat_tok], torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
    disp = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device).index_put(
        (slot_e, slot_c), vals, accumulate=True)
    # chunk p (the experts rank p owns) goes to rank p; from every source
    # rank s this rank receives the slots of its own experts
    recv = tp.all_to_all(disp.reshape(n, local_e, cap, d), ep.group)
    recv = recv.transpose(0, 1).reshape(local_e, n * cap, d)
    y = torch.stack([_expert_ffn(params["w_in"][le], params["b_in"][le], params["w_out"][le],
                                 params["b_out"][le], recv[le]) for le in range(local_e)])
    y = y.reshape(local_e, n, cap, d).transpose(0, 1)
    back = tp.all_to_all(y, ep.group).reshape(e, cap, d)
    contrib = back[slot_e, slot_c] * torch.where(keep, flat_w, 0.0)[:, None].to(x.dtype)
    out = torch.zeros_like(x).index_add(0, flat_tok, contrib)
    return out, keep.sum().to(torch.float32), flat_valid.sum().to(torch.float32)


def capacity(tokens: int, n: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and source rank for ``tokens`` split over ``n``."""
    return max(1, int(math.ceil(-(-tokens // n) * top_k / num_experts * capacity_factor)))


def moe_ffn_dispatch(params: dict, x: torch.Tensor, ep, top_k: int = 2,
                     capacity_factor: float = 2.0, data=None):
    """Switch-routed MoE on ``[T, d]`` tokens replicated over the expert
    group ``ep`` (JAX ``dispatch_inline``): the tokens split over the
    group (padded to a multiple; pad tokens take no slot), routed through
    the two all_to_alls, all-gathered back. Returns ``(out [T, d],
    dropped)``, ``dropped`` the fraction of assignments lost to the
    capacity over the expert group and the data group ``data`` (a
    ``tp.Shard`` or None)."""
    e = params["gate"].shape[-1]
    if e % ep.size:
        raise ValueError(f"expert-axis size {ep.size} must divide num_experts {e}")
    t, d = x.shape
    n = ep.size
    ss = -(-t // n)
    cap = capacity(t, n, top_k, e, capacity_factor)
    # each rank routes its own tokens: the input's and the gate's gradients
    # are summed over the group
    x = tp.enter(x, ep.group)
    params = {**params, "gate": tp.enter(params["gate"], ep.group)}
    mine = F.pad(x, (0, 0, 0, ss * n - t))[ep.index * ss:(ep.index + 1) * ss]
    valid = (ep.index * ss + torch.arange(ss, device=x.device)) < t
    out_l, kept, total = _rank_dispatch(params, mine, valid, ep, top_k, cap)
    out = tp.gather(out_l, ep, dim=0)[:t]
    counts = torch.stack([kept, total])
    for group in (ep.group, None if data is None else data.group):
        counts = tp.reduce_out(counts, group)
    return out, 1.0 - counts[0] / torch.clamp_min(counts[1], 1.0)

