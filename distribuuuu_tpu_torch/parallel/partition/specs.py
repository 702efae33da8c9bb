"""Per-leaf placement of the port's state (the subset of
distribuuuu_tpu/parallel/partition/specs.py the port runs: ``SpecRule``,
``SpecTable``, ``lm_spec_table`` and the ViT's leaf rules), and the
state-dict shard and gather that replace GSPMD's placement.

A spec is a tuple, one entry a dim of the PORT's tensor (torch's
``[out, in]`` Linear weight, the JAX layout elsewhere): the mesh axis the
dim is split over, or None. The rules restate, leaf by leaf, what the JAX
package's ``state_layout`` declares for the same arch and stanza (its
``[in, out]`` kernels transposed): every Linear weight split on its output
rows over ``model`` (the column-parallel Dense kernels), the LM's token
embedding on its feature dim and its head's bias over ``model``, the
expert tensors on their expert dim over the MoE axis; the rest replicated.

:func:`place_model` splits a built model's parameters to this rank's
shards and tells each sharded layer where its tensors lie; a checkpoint
holds full tensors (:func:`gather_state_dict`, collective over the
groups) and a load slices them (:func:`shard_state_dict`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from distribuuuu_tpu_torch.parallel import tp


@dataclass(frozen=True)
class SpecRule:
    """Leaves whose key matches ``pattern`` (``re.search``) get ``spec``."""

    pattern: str
    spec: tuple


class SpecTable:
    """Ordered key-pattern -> spec rules; an unmatched key is replicated."""

    def __init__(self, rules=()):
        self.rules = tuple(rules)

    def spec_for(self, key: str) -> tuple:
        for rule in self.rules:
            if re.search(rule.pattern, key):
                return rule.spec
        return ()


_BLOCK_LINEARS = (
    SpecRule(r"blocks\.\d+\.attn\.(qkv|proj)\.weight$", ("model", None)),
    SpecRule(r"blocks\.\d+\.mlp\.(fc1|fc2)\.weight$", ("model", None)),
)


def _expert_rules(moe_axis: str) -> tuple:
    return (SpecRule(r"blocks\.\d+\.mlp\.(w_in|w_out|b_in|b_out)$", (moe_axis,)),)


def vit_spec_table(moe_axis: str = "model") -> SpecTable:
    """The ViT's leaves: the block Linears and the head's weight column-
    parallel (the JAX Dense kernels' ``P(None, "model")``), their biases,
    the patch conv, ``pos_embed``, the norms and the gate replicated; the
    expert tensors on ``moe_axis``."""
    return SpecTable((*_BLOCK_LINEARS, SpecRule(r"^head\.weight$", ("model", None)),
                      *_expert_rules(moe_axis)))


def lm_spec_table(moe_axis: str = "model") -> SpecTable:
    """The LM's leaves (JAX ``lm_spec_table``): the token embedding
    ``[V, D]`` on its feature dim, the head column-parallel with its bias
    (vocab-parallel logits), ``pos_embed`` replicated, the block Linears
    and experts as the ViT's."""
    return SpecTable((
        SpecRule(r"^tok_embed\.weight$", (None, "model")),
        SpecRule(r"^head\.weight$", ("model", None)),
        SpecRule(r"^head\.bias$", ("model",)),
        *_BLOCK_LINEARS, *_expert_rules(moe_axis)))


def table_for(arch: str, moe_axis: str = "model") -> SpecTable:
    if arch.startswith("gpt"):
        return lm_spec_table(moe_axis)
    if arch.startswith("vit"):
        return vit_spec_table(moe_axis)
    return SpecTable()


def split_of(table: SpecTable, key: str, sizes: dict) -> tuple[str, int] | None:
    """``(axis, dim)`` where ``key`` is split under axis ``sizes``, or None
    when it is whole on every rank."""
    for dim, axis in enumerate(table.spec_for(key)):
        if axis is not None and sizes.get(axis, 1) > 1:
            return axis, dim
    return None


def shard_state_dict(sd: dict, table: SpecTable, sizes: dict, coords: dict) -> dict:
    """The shard of each full tensor of ``sd`` that the rank at ``coords``
    holds (a copy; whole tensors as they are)."""
    out = {}
    for key, t in sd.items():
        split = split_of(table, key, sizes)
        if split is None or not torch.is_tensor(t):
            out[key] = t
            continue
        axis, dim = split
        out[key] = tp.Shard(None, coords[axis], sizes[axis], dim).take(t).clone()
    return out


def gather_state_dict(sd: dict, shards: dict) -> dict:
    """``sd``'s shards (``shards``: a placed model's ``{key: Shard}``) put
    together into full tensors, on every rank: a collective over each
    split key's group, in key order, so every rank calls it at the same
    point."""
    import torch.distributed as tdist

    out = {}
    for key, t in sd.items():
        sh = shards.get(key)
        if sh is None or not torch.is_tensor(t):
            out[key] = t
            continue
        parts = [torch.empty_like(t) for _ in range(sh.size)]
        tdist.all_gather(parts, t.contiguous(), group=sh.group)
        out[key] = torch.cat(parts, sh.dim)
    return out


def local_state_dict(sd: dict, shards: dict) -> dict:
    """This rank's slices of a full state dict ``sd`` (views)."""
    return {k: shards[k].take(v) if k in shards and torch.is_tensor(v) else v
            for k, v in sd.items()}


def _opt_map(state: dict, fn) -> dict:
    return {**state, **{k: None if state.get(k) is None else fn(state[k]) for k in ("m", "v")}}


def full_train_state(model, optimizer) -> dict:
    """The model's and the optimizer's state as one process would hold
    them (full tensors; collective under a sharded placement)."""
    shards = getattr(model, "shards", {})
    if not shards:
        return {"model": model.state_dict(), "opt": optimizer.state_dict()}
    return {"model": gather_state_dict(model.state_dict(), shards),
            "opt": _opt_map(optimizer.state_dict(), lambda d: gather_state_dict(d, shards))}


def load_full_model(model, sd: dict, strict: bool = True):
    """Load a full state dict into a (possibly placed) model."""
    return model.load_state_dict(local_state_dict(sd, getattr(model, "shards", {})),
                                 strict=strict)


def load_full_opt(model, optimizer, state: dict) -> None:
    """Load a full optimizer state into the optimizer of a placed model."""
    optimizer.load_state_dict(
        _opt_map(state, lambda d: local_state_dict(d, getattr(model, "shards", {}))))


def place_model(model: torch.nn.Module, mesh, table: SpecTable) -> torch.nn.Module:
    """Split ``model``'s parameters (built whole, the same on every rank)
    to this rank's shards by ``table``, and hand each layer its
    placement: a Linear its column :class:`~distribuuuu_tpu_torch.
    parallel.tp.Shard` (``shard``, ``bias_sharded``), the LM its embedding
    shard (``embed_shard``), a MoE layer its expert shard (``ep``) and the
    data group its balancing statistics average over. On the one-process
    mesh nothing changes."""
    shards = {}
    with torch.no_grad():
        for key, p in model.named_parameters():
            split = split_of(table, key, mesh.sizes)
            if split is None:
                continue
            axis, dim = split
            shards[key] = tp.Shard(mesh.group(axis), mesh.index(axis), mesh.size(axis), dim)
            p.data = shards[key].take(p.data).clone()
    data = (tp.Shard(mesh.group("data"), mesh.index("data"), mesh.size("data"))
            if mesh.size("data") > 1 else None)
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if hasattr(m, "bias_sharded"):
            m.shard = shards.get(f"{prefix}weight")
            m.bias_sharded = f"{prefix}bias" in shards
        if hasattr(m, "embed_shard"):
            m.embed_shard = shards.get(f"{prefix}tok_embed.weight")
        if hasattr(m, "ep"):
            m.ep = shards.get(f"{prefix}w_in")
            m.data = data
    model.shards = shards
    return model
