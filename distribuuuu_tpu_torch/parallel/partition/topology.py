"""The topology registry of the port (counterpart of
distribuuuu_tpu/parallel/partition/topology.py): resolve a ``MESH`` stanza
against the number of processes (one card a process) into a
:class:`Topology`, and validate it against the JAX package's capability
rules, with their names and messages. A stanza the rules pass but the port
does not run yet (a pipe or sequence axis, a model axis on a CNN)
raises ``not_ported`` after the rules, naming the ROADMAP item that holds
it; :func:`from_cfg` does both, :func:`validate` the rules alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from distribuuuu_tpu_torch import not_ported

PARALLEL = "Parallel layouts beyond DP"


class TopologyError(ValueError):
    """A MESH stanza the capability table refuses; ``rule`` names the rule."""

    def __init__(self, msg: str, rule: str = ""):
        super().__init__(msg)
        self.rule = rule


# depth of the shipped ViT archs: an indivisible pipe size is refused here
_VIT_DEPTH = {"vit_tiny": 12, "vit_small": 12, "vit_tiny_moe": 12}

MESH_AXES = ("data", "model", "seq", "pipe", "expert")


def resolve_axis_sizes(sizes, n_devices: int) -> list[int]:
    """Resolve ``-1``/``0`` wildcard entries against ``n_devices`` (the
    JAX package's ``parallel/mesh.resolve_axis_sizes``): ``0`` means 1,
    ``-1`` on at most one axis means every remaining device, and the
    product must equal the device count."""
    sizes = [1 if s == 0 else int(s) for s in sizes]
    if sum(1 for s in sizes if s == -1) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {sizes}")
    fixed = 1
    for s in sizes:
        if s != -1:
            fixed *= s
    if fixed <= 0 or n_devices % fixed != 0:
        raise ValueError(f"Mesh axes {sizes} do not divide device count {n_devices}")
    sizes = [n_devices // fixed if s == -1 else s for s in sizes]
    total = 1
    for s in sizes:
        total *= s
    if total != n_devices:
        raise ValueError(f"Mesh {dict(zip(MESH_AXES, sizes))} uses {total} devices but "
                         f"{n_devices} are available")
    return sizes


@dataclass(frozen=True)
class Topology:
    """One resolved point of the mesh space: axis sizes and the ZeRO stage."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    zero: int = 0

    @property
    def axes(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model, "seq": self.seq,
                "pipe": self.pipe, "expert": self.expert}

    def devices(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def class_name(self) -> str:
        """``dp2·tp2·ep2``-style name (``dp1`` for one device)."""
        parts = [f"{feat}{size}" for feat, size in zip(("dp", "tp", "sp", "pp", "ep"),
                                                        self.axes.values()) if size > 1]
        if self.zero:
            parts.append(f"zero{self.zero}")
        return "·".join(parts) or "dp1"

    def moe_axis(self) -> str:
        """The axis the expert tensors ride: ``expert`` when populated, else
        the legacy ``model`` axis."""
        return "expert" if self.expert > 1 else "model"


@dataclass(frozen=True)
class Rule:
    """One capability refusal: ``broken(topo, arch, moe)`` gives the
    error, or None when the stanza is fine."""

    name: str
    broken: Callable

    def check(self, topo: Topology, arch: str, moe) -> str | None:
        return self.broken(topo, arch, moe)


def _is_vit(arch: str) -> bool:
    return arch.startswith("vit")


def _is_gpt(arch: str) -> bool:
    return arch.startswith("gpt")


def _is_moe(arch: str) -> bool:
    return arch.endswith("_moe")


def _rule_zero_stage(t, arch, moe):
    if t.zero not in (0, 1, 3):
        return (f"MESH.ZERO={t.zero}: stages are 0 (off), 1 (optimizer state "
                "sharded over data), 3 (params too — FSDP); stage 2 is "
                "subsumed by 1 in a fused jit step (parallel/zero.py)")
    return None


def _rule_pipe_arch(t, arch, moe):
    if t.pipe > 1 and not _is_vit(arch):
        return (f"MESH.PIPE={t.pipe}: only the ViT archs satisfy the "
                "uniform-stage pipeline contract (parallel/pp.py); a CNN's "
                "shrinking stage pyramid does not — use MESH.DATA/MODEL "
                "for those archs")
    return None


def _rule_pipe_depth(t, arch, moe):
    depth = _VIT_DEPTH.get(arch)
    if t.pipe > 1 and depth is not None and depth % t.pipe:
        return (f"MESH.PIPE={t.pipe}: depth {depth} of {arch!r} not divisible "
                "by pipe_stages (models/vit.PipelinedViT uniform-stage "
                "contract)")
    return None


def _rule_pipe_moe_every(t, arch, moe):
    depth = _VIT_DEPTH.get(arch)
    if (t.pipe > 1 and _is_moe(arch) and depth is not None and moe is not None
            and (depth // t.pipe) % int(moe.EVERY)):
        return (f"MESH.PIPE={t.pipe} with {arch!r}: PP×MoE needs "
                f"blocks-per-stage ({depth // t.pipe}) divisible by "
                f"MODEL.MOE.EVERY ({int(moe.EVERY)}); adjust MESH.PIPE or "
                "MODEL.MOE.EVERY")
    return None


def _rule_pipe_seq(t, arch, moe):
    if t.pipe > 1 and t.seq > 1:
        return (f"MESH.PIPE={t.pipe} with MESH.SEQ={t.seq}: sequence-SHARDED "
                "(ring/ulysses) attention does not compose with the pipe axis "
                "— PP shards depth, SP shards tokens; per-device "
                "flash/blockwise attention inside stages is supported instead "
                "(DEVICE.ATTN_IMPL flash)")
    return None


def _rule_seq_arch(t, arch, moe):
    if t.seq > 1 and not (_is_vit(arch) or _is_gpt(arch)):
        return (f"MESH.SEQ={t.seq}: only the ViT and GPT archs route "
                "attention over the seq axis (ring/ulysses, "
                "ops/ring_attention.py); CNN archs have no sequence dimension "
                "to shard (the axis would be silently replicated)")
    return None


def _rule_expert_arch(t, arch, moe):
    if t.expert > 1 and not _is_moe(arch):
        return (f"MESH.EXPERT={t.expert}: only the *_moe archs dispatch "
                "experts; a dense arch would silently replicate the whole "
                "computation over the expert axis — use MESH.DATA/MODEL "
                "for those archs")
    return None


def _rule_expert_divides(t, arch, moe):
    if t.expert > 1 and moe is not None and int(moe.NUM_EXPERTS) % t.expert:
        return (f"MESH.EXPERT={t.expert} must divide MODEL.MOE.NUM_EXPERTS="
                f"{int(moe.NUM_EXPERTS)} (each expert-axis rank owns an equal "
                "slice of the expert tensors)")
    return None


def _rule_expert_seq(t, arch, moe):
    if t.expert > 1 and t.seq > 1:
        return (f"MESH.EXPERT={t.expert} with MESH.SEQ={t.seq}: sequence-"
                "sharded attention and dedicated-axis expert dispatch both "
                "want the token dim — compose EP with data/model/pipe axes "
                "instead")
    return None


RULES: tuple[Rule, ...] = (
    Rule("zero_stage", _rule_zero_stage),
    Rule("pipe_arch", _rule_pipe_arch),
    Rule("pipe_depth", _rule_pipe_depth),
    Rule("pipe_moe_every", _rule_pipe_moe_every),
    Rule("pipe_seq", _rule_pipe_seq),
    Rule("seq_arch", _rule_seq_arch),
    Rule("expert_arch", _rule_expert_arch),
    Rule("expert_divides", _rule_expert_divides),
    Rule("expert_seq", _rule_expert_seq),
)


def validate(topo: Topology, arch: str, moe=None) -> Topology:
    """Run the capability table: :class:`TopologyError` with the first
    broken rule's message (and name), else ``topo`` unchanged."""
    for rule in RULES:
        msg = rule.check(topo, arch, moe)
        if msg is not None:
            raise TopologyError(msg, rule.name)
    return topo


def refuse_unported(topo: Topology, arch: str) -> Topology:
    """``not_ported`` for a valid stanza the port does not run yet."""
    if topo.pipe > 1:
        raise not_ported(f"the pipelined ViT (MESH.PIPE={topo.pipe})", PARALLEL)
    if topo.seq > 1:
        raise not_ported(f"sequence-sharded attention (MESH.SEQ={topo.seq})", PARALLEL)
    if topo.model > 1 and not (_is_vit(arch) or _is_gpt(arch)):
        raise not_ported(f"a model axis on the CNN {arch!r} (MESH.MODEL={topo.model}: "
                         "output-channel-sharded convs)", PARALLEL)
    return topo


def from_cfg(cfg, n_devices: int | None = None) -> Topology:
    """Resolve and validate the config's MESH stanza against ``n_devices``
    (default: the number of processes the environment launches), then
    refuse what the port does not run: all before any work."""
    if n_devices is None:
        from distribuuuu_tpu_torch.parallel import dist

        n_devices = dist.env_world_size()
    m = cfg.MESH
    sizes = resolve_axis_sizes([m.DATA, m.MODEL, m.SEQ, m.PIPE, m.EXPERT], n_devices)
    topo = Topology(*sizes, zero=int(m.ZERO))
    validate(topo, cfg.MODEL.ARCH, cfg.MODEL.MOE)
    return refuse_unported(topo, cfg.MODEL.ARCH)
