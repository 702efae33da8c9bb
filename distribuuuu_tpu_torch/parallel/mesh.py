"""The mesh of processes (counterpart of distribuuuu_tpu/parallel/mesh.py's
``build_mesh``): one process a card, rank r at the coordinates of r in the
row-major ``(data, model, seq, pipe, expert)`` grid of a
:class:`~distribuuuu_tpu_torch.parallel.partition.topology.Topology`, the
expert axis innermost, as the JAX package reshapes its device list.

Each populated axis has one process group a line (the ranks that differ
in that coordinate only): the data groups average the gradients and the
metrics, the model groups carry the column-parallel Linears
(``parallel/tp.py``) and, at ``MESH.EXPERT`` 1, the experts; the expert
groups carry the experts. :func:`setup` builds it after the process group
is up (every process makes every line's group, in the same order);
:func:`current` is the mesh of this process, the one-process identity
(every axis 1, no group) until then.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from distribuuuu_tpu_torch.parallel import dist
from distribuuuu_tpu_torch.parallel.partition.topology import MESH_AXES, Topology


@dataclass
class Mesh:
    """Axis sizes, this rank's coordinates and its group on each axis
    (None where the axis has one rank)."""

    sizes: dict = field(default_factory=lambda: dict.fromkeys(MESH_AXES, 1))
    coords: dict = field(default_factory=lambda: dict.fromkeys(MESH_AXES, 0))
    groups: dict = field(default_factory=lambda: dict.fromkeys(MESH_AXES))

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def sharded(self) -> bool:
        """True when a parameter is split over some axis (model or expert)."""
        return self.sizes["model"] > 1 or self.sizes["expert"] > 1

    def data_coords(self) -> tuple[int, int]:
        """``(data index, data size)``: the sampler's shard. Every rank of
        one model x expert line reads the same batches."""
        return self.coords["data"], self.sizes["data"]

    def topology(self) -> Topology:
        return Topology(**self.sizes)


def coords_of(rank: int, sizes: dict) -> dict:
    """The row-major ``(data, model, seq, pipe, expert)`` coordinates of
    ``rank``."""
    out = {}
    for axis in reversed(MESH_AXES):
        out[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {a: out[a] for a in MESH_AXES}


def rank_of(coords: dict, sizes: dict) -> int:
    r = 0
    for axis in MESH_AXES:
        r = r * sizes[axis] + coords[axis]
    return r


def axis_lines(axis: str, sizes: dict) -> list[list[int]]:
    """Every line of ranks along ``axis``, in rank order of its first rank."""
    world = 1
    for v in sizes.values():
        world *= v
    lines, seen = [], set()
    for r in range(world):
        if r in seen:
            continue
        c = coords_of(r, sizes)
        line = [rank_of({**c, axis: i}, sizes) for i in range(sizes[axis])]
        seen.update(line)
        lines.append(line)
    return lines


_current = Mesh()


def current() -> Mesh:
    return _current


def setup(topo: Topology) -> Mesh:
    """The mesh of this process for ``topo``; makes the groups of every
    populated axis (a collective call: every process, the same order) and
    makes it :func:`current`."""
    global _current
    sizes = dict(topo.axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if topo.devices() != world:
        raise ValueError(f"MESH {topo.class_name()} spans {topo.devices()} processes; "
                         f"{world} are running")
    groups = dict.fromkeys(MESH_AXES)
    if world > 1:
        import torch.distributed as tdist

        for axis in MESH_AXES:
            if sizes[axis] == 1:
                continue
            if sizes[axis] == world:
                groups[axis] = tdist.group.WORLD
                continue
            for line in axis_lines(axis, sizes):
                g = tdist.new_group(line)
                if rank in line:
                    groups[axis] = g
    _current = Mesh(sizes, coords_of(rank, sizes), groups)
    return _current


def reset() -> None:
    """Back to the one-process identity (tests; after the group is gone)."""
    global _current
    _current = Mesh()
