"""One CUDA graph per step: the port's counterpart of the JAX package's
lowering and compiling (distribuuuu_tpu/parallel/partition/lowering.py,
the engines' ``.lower(...).compile()``).

A :class:`StepGraph` wraps a body (a train step, K folded steps, an eval
step, a serving bucket's forward, an LM decode or prompt tile) that reads
only static device buffers and does no host read. On the card its first
call runs the body eagerly on a side stream (the warm-up: cuDNN picks its
algorithms, cuBLAS and the kernels' workspaces are made there, and the
call's work is real) and then captures it into a ``torch.cuda.CUDAGraph``
on the owner's private memory pool; every later call replays the graph.
On the CPU every call runs the body eagerly on the same static buffers:
the tensor's device is the one policy point, as for the kernels. A
capture that fails raises; nothing runs the body eagerly on the card
instead. An owner that must run eagerly on the card builds its graphs
with ``graphed=False``, decided before the first call: a gloo group
holding CUDA tensors (gloo cannot be captured), concurrent eval (on its
own stream over a snapshot), or an engine built to measure the graphs
against their eager bodies.

* **Inputs.** ``graph(**src)`` copies each source into the static input
  of that name on the current stream, then runs. What changes every step
  and comes from the host (dropout masks, optimizer scalars, the poison
  scale) is written by :func:`stage` into static device buffers before
  the call, outside the graph.
* **Outputs.** The static outputs are overwritten by the next replay; a
  caller that keeps them past it copies them out.
* **Addresses.** A graph reads the addresses it was captured with. What
  it reads besides its pool (a kernel's workspace) is handed to
  :func:`keep_alive` during the capture and lives as long as the graph.
* **Launch counts.** Every kernel wrapper adds one to its count where it
  launches. A capture launches nothing, so the counts' deltas over the
  capture are taken back and added again on every replay: a count is the
  launches the card ran.
* **Lifetime.** A body closes over what it reads, never over its owner
  (the engine or step that holds the graph): no reference cycle runs
  through a graph, so it and its share of the pool are freed the moment
  its owner is dropped, not at some later garbage collection.
* ``captures`` counts every capture of the process (the engines'
  ``n_compiles`` and the train record's ``captures`` read it).
* **Telemetry.** A capture is the port's compile: once it is done (never
  inside it) ``telemetry/runtime.on_capture`` lands a ``kind="compile"``
  record of the warm-up and capture seconds. The first call resets the
  allocator's peak and keeps the peak over itself in
  ``first_call_peak`` (the graph's memory, ``cost.memory``). Nothing in a
  body emits a record: a body runs once, at capture, and never on a
  replay.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from distribuuuu_tpu_torch.ops import cuda as kernel_tier
from distribuuuu_tpu_torch.telemetry import runtime as telemetry_runtime

captures = 0  # graphs captured in this process
_local = threading.local()  # .graph: the StepGraph this thread is capturing


def graphed(device: torch.device) -> bool:
    """Whether a StepGraph on ``device`` captures by default: on a CUDA
    device."""
    return torch.device(device).type == "cuda"


_on_card = graphed  # StepGraph's default, under a name its argument does not shadow


def keep_alive(*tensors) -> None:
    """Tie ``tensors`` to the graph this thread is capturing, if any: they
    live as long as it does, whoever else drops them."""
    g = getattr(_local, "graph", None)
    if g is not None:
        g.keep.extend(t for t in tensors if t is not None)


def capturing() -> bool:
    """True while this thread captures a StepGraph."""
    return getattr(_local, "graph", None) is not None


def stage(dst: torch.Tensor, src) -> None:
    """Copy host data (an array or a CPU tensor) into the static buffer
    ``dst``, on the current stream, ahead of the next call: through a
    fresh pinned buffer on the card (the caching host allocator keeps it
    until the copy is done), directly on the CPU."""
    src = torch.as_tensor(np.asarray(src) if not torch.is_tensor(src) else src).to(dst.dtype)
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class StepGraph:
    """A body over static buffers, captured once and replayed (module
    docstring). ``inputs`` maps names to the static input buffers
    ``__call__`` fills; ``pool`` is the owner's memory pool (None: a pool
    of the graph's own); ``stream`` the owner's side stream; ``graphed``
    the owner's choice (None: :func:`graphed` of ``device``)."""

    def __init__(self, body, inputs: dict | None = None, *, device, pool=None,
                 stream=None, graphed: bool | None = None):
        self.body = body
        self.inputs = dict(inputs or {})
        self.device = torch.device(device)
        self.graphed = _on_card(self.device) if graphed is None else bool(graphed)
        self.pool = pool
        self.stream = stream
        self.graph = None
        self.outputs = None
        self.keep: list = []
        self.launches: dict = {}  # kernel launches a replay adds
        self.first_call_peak = None  # allocator peak bytes over the first call

    def __call__(self, **src):
        for k, v in src.items():
            self.inputs[k].copy_(v, non_blocking=True)
        if not self.graphed:
            return self.body()
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        kernel_tier.add_launches(self.launches)
        return self.outputs

    def _warm_and_capture(self):
        global captures
        dev = self.device
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        side = self.stream or torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self.body()  # the warm-up: a real call
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        before = kernel_tier.launch_counts()
        _local.graph = self
        try:
            with torch.cuda.graph(g, pool=self.pool, stream=side):
                self.outputs = self.body()
        finally:
            _local.graph = None
            after = kernel_tier.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            kernel_tier.add_launches({k: -n for k, n in self.launches.items()})
        self.graph = g
        captures += 1
        self.first_call_peak = torch.cuda.max_memory_allocated(dev)
        telemetry_runtime.on_capture(time.perf_counter() - t0)
        return out


def pool_bytes(pool) -> int:
    """The bytes the caching allocator holds for the graph memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``), over every card."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def capture_trivial(n: int, device) -> int:
    """Capture ``n`` trivial graphs (``x + 1``) at ``n`` distinct shapes,
    each after its warm-up call, and replay each once: real captures that
    touch no state of the run (``FAULTS.RECOMPILE_*``). Returns ``n``;
    raises off the card."""
    device = torch.device(device)
    if not graphed(device):
        raise ValueError(f"a graph capture needs the card; {device} has none")
    pool = torch.cuda.graph_pool_handle()
    for i in range(n):
        x = torch.zeros(i + 2, device=device)
        g = StepGraph(lambda x=x: x + 1.0, device=device, pool=pool)
        g()
        g()
    return n
