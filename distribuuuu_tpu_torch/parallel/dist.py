"""Process-group bootstrap and collectives (counterpart of
distribuuuu_tpu/parallel/mesh.py:40-155 and parallel/collectives.py).

One process per card. ``setup_distributed`` reads the JAX package's three
bootstrap modes from the environment:

* ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` (``torchrun``; ``MASTER_PORT``
  when set), a group of one process included, as ``torchrun
  --nproc_per_node 1`` makes;
* ``COORDINATOR_ADDRESS`` (``host:port``)/``NUM_PROCESSES``/``PROCESS_ID``;
* Slurm's ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_NODELIST``, the first
  host of the allocation (``scontrol show hostname``) as the coordinator;

and then ``init_process_group`` over ``tcp://host:port`` (port 29566 by
default, ``COORDINATOR_PORT`` overrides): NCCL for a CUDA device, gloo on
the CPU, or the backend the caller names. With none of them set (or one
Slurm task) it does nothing and every helper below is the one-process
identity. ``all_reduce_grads`` is the gradient all-reduce DDP would do,
one collective per flat bucket; the model's BatchNorm does its own
collectives (``models/layers.BatchNorm``).
"""

from __future__ import annotations

import datetime
import functools
import os
import subprocess

import torch
import torch.distributed as dist

DEFAULT_PORT = 29566  # the reference's default port
BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket size

_groups: dict[int, object] = {}


def _slurm_env() -> tuple[str, int, int]:
    proc_id = int(os.environ["SLURM_PROCID"])
    n_procs = int(os.environ["SLURM_NTASKS"])
    addr = subprocess.run(["scontrol", "show", "hostname", os.environ["SLURM_NODELIST"]],
                          capture_output=True, text=True, check=True).stdout.split()[0]
    return addr, n_procs, proc_id


def bootstrap_env(port: int | None = None) -> tuple[str, int, int, int] | None:
    """``(addr, port, world, rank)`` of the launch the environment names
    (torchrun's group of one included), or None. Reads the environment
    (and, under Slurm, ``scontrol``) only."""
    env = os.environ
    port = port or int(env.get("COORDINATOR_PORT", DEFAULT_PORT))
    if "COORDINATOR_ADDRESS" in env:
        host, _, p = env["COORDINATOR_ADDRESS"].rpartition(":")
        return host, int(p), int(env["NUM_PROCESSES"]), int(env["PROCESS_ID"])
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        addr, world, rank = _slurm_env()
        return addr, port, world, rank
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        return (env["MASTER_ADDR"], int(env.get("MASTER_PORT", port)),
                int(env["WORLD_SIZE"]), int(env.get("RANK", 0)))
    return None


def env_world_size() -> int:
    """The number of processes the environment launches (1 when none is
    named), readable before any process group exists. A Slurm launch is
    counted by ``SLURM_NTASKS`` without asking ``scontrol``."""
    env = os.environ
    if "COORDINATOR_ADDRESS" in env:
        return int(env["NUM_PROCESSES"])
    if "SLURM_PROCID" in env:
        return int(env.get("SLURM_NTASKS", "1"))
    if "MASTER_ADDR" in env:
        return int(env.get("WORLD_SIZE", "1"))
    return 1


def setup_distributed(backend: str | None = None, port: int | None = None,
                      timeout_s: float = 1800.0) -> bool:
    """Join the process group the environment describes (see the module
    docstring); ``backend`` defaults to NCCL when CUDA is available, else
    gloo. Returns True when a group is up. Idempotent."""
    if dist.is_initialized():
        return True
    boot = bootstrap_env(port)
    if boot is None:
        return False
    addr, port, world, rank = boot
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown_distributed() -> None:
    """Leave the process group (and forget the rank groups and the mesh)."""
    from distribuuuu_tpu_torch.parallel import mesh

    _groups.clear()
    mesh.reset()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    """This process's index among the processes of its node."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", 0)))


def is_primary() -> bool:
    """True on the process that logs and writes checkpoints."""
    return get_rank() == 0


def capturable() -> bool:
    """Whether the default group's collectives can be captured in a CUDA
    graph: no group (the one-process identity), or NCCL. gloo cannot be
    captured, whatever device its tensors lie on."""
    return not is_initialized() or dist.get_backend() == "nccl"


def collective_device(group=None) -> torch.device:
    """Where a host value goes for a collective on ``group`` (default: the
    whole group): NCCL takes CUDA tensors only (on the device set for this
    process), gloo the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def broadcast_from_primary(obj):
    """``obj`` as the primary holds it, on every process (any picklable)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_tensors_from_primary(tensors) -> None:
    """Overwrite each tensor with the primary's, in place (DDP's start-up
    parameter broadcast)."""
    if is_initialized():
        for t in tensors:
            dist.broadcast(t, src=0)


def all_reduce_sum(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The sum over ``group``'s processes (default: all) of each tensor (all
    of one shape, in their common dtype). One collective for the lot; on
    a ``group`` of another device (``side_group``'s CPU) the values go
    there and come back."""
    if not is_initialized():
        return list(tensors)
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    flat = torch.stack([t.to(dtype) for t in tensors])
    if group is None:
        dist.all_reduce(flat)
    else:
        moved = flat.to(collective_device(group))
        dist.all_reduce(moved, group=group)
        flat = moved.to(flat.device)
    return list(flat.unbind(0))


def side_group():
    """A gloo group of every process, for collectives of a second host
    thread (concurrent eval's sums): its own communicator, so they never
    interleave with the training thread's on the default group, and CPU
    tensors, so they never compete with NCCL's kernels on the card. Every
    process must create it at the same point. None with no process group."""
    if not is_initialized():
        return None
    return dist.new_group(list(range(get_world_size())), backend="gloo")


def _size(group) -> int:
    return get_world_size() if group is None else dist.get_world_size(group)


def scaled_all_reduce(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The mean over ``group``'s processes (default: all) of each tensor:
    sum, then scale by 1/size (the reference's ``scaled_all_reduce``). One
    collective for the lot. Under a model or expert axis the caller passes
    the data group: the ranks of one line hold the same values."""
    if not is_initialized():
        return list(tensors)
    if group is None:
        return [t / get_world_size() for t in all_reduce_sum(tensors)]
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    flat = torch.stack([t.to(dtype) for t in tensors])
    dist.all_reduce(flat, group=group)
    return list((flat / _size(group)).unbind(0))


def all_reduce_grads(grads: list[torch.Tensor], group=None) -> None:
    """Average each gradient over ``group``'s processes (default: all), in
    place: the gradients are packed in order into flat buckets of one
    dtype and at most ``BUCKET_BYTES`` (a larger tensor is a bucket
    alone), one all-reduce a bucket, then scaled by 1/size and written
    back in each tensor's own layout. Under a model or expert axis it is
    the data group: the other axes' ranks hold a shard or a whole copy of
    the same gradient."""
    if not is_initialized():
        return
    world = _size(group)
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if not buckets or buckets[-1][0].dtype != g.dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat /= world
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()


def synced_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s processes, differentiable: the
    backward sums the cotangents over the same processes."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def rank_group(span: int):
    """The process group of the ``span`` consecutive ranks this process
    belongs to (``torch.distributed.group.WORLD`` at ``span >= world``).
    Every process must make the same calls in the same order: the first
    call for a ``span`` creates all of its groups."""
    world = get_world_size()
    if span >= world:
        return dist.group.WORLD
    if world % span:
        raise ValueError(f"{span} ranks a group do not tile {world} processes")
    if span not in _groups:
        mine = None
        for start in range(0, world, span):
            g = dist.new_group(list(range(start, start + span)))
            if start <= get_rank() < start + span:
                mine = g
        _groups[span] = mine
    return _groups[span]
