"""The FLOP/byte ledger, in place of XLA's cost analysis (counterpart of
distribuuuu_tpu/telemetry/costmodel.py, the same ``cost.*`` records).

XLA reads a step's flops and bytes off its compiled program. The port has
no such program, so it counts the step itself, once per step label and
run (the sink's setup forgets the labels seen): on a copy of the model on
the ``meta`` device (no memory, no data, the live model's parameters,
buffers, BN running stats, the optimizer and every generator untouched),
through the model's plain path (a hand kernel's wrapper takes its plain
PyTorch version on a meta tensor), under a ``TorchDispatchMode``
(:class:`OpCounter`) that adds each aten op's FLOPs from
``torch.utils.flop_counter``'s formulas (matmuls, convolutions, attention;
2 a multiply-add; 0 for elementwise ops; a convolution's backward counted
per gradient with its groups, which the library's formula drops) and the
bytes of its operands and outputs (views move none). A ``train_step`` is the forward, the loss,
the backward and the optimizer's update; eval and serving buckets the
forward. The count is then the same work whatever implements it: the same
on the CPU as on the card, and unmoved by a faster kernel. ``source``
names how a count was made: ``"dispatch"``, or ``"analytic"`` (JAX's hand
table, :data:`ANALYTIC_FWD_FLOPS_PER_IMG`, when the count fails).

Records (``spans.emit_event``), per step, for one process (one card):

* ``cost.step``: flops, bytes, images (or LM sequences) a step, the card's
  peak (:data:`DEVICE_PEAKS`, keyed by ``torch.cuda.get_device_name``);
* ``cost.roofline``: flops / bytes against the ridge ``peak flops /
  bandwidth``, the bound;
* ``cost.memory``: the graph's own first call (its warm-up and capture,
  ``graphs.StepGraph.first_call_peak``, the allocator's peak over it)
  against the card's capacity (``torch.cuda.mem_get_info()[1]``, the
  allocator's real budget): ``headroom_pct``, ``source "graph"``. A CPU
  run has no graph and writes none.

Nothing here runs inside a timed window or a capture: the callers count
before a label's first call and read the memory after it.
"""

from __future__ import annotations

import copy
import math
import os

import torch

SCHEMA = 1

# Per-device peaks: dense bf16 FLOP/s, memory bandwidth (bytes/s), capacity.
# The H100's are the numbers PERF.md's kernel bounds use; its capacity is
# read from the allocator when the card is present. The CPU entry is
# nominal (DTPU_CPU_PEAK_FLOPS / DTPU_CPU_PEAK_BW override it), its
# capacity the host's RAM.
DEVICE_PEAKS: dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"flops": 989.4e12, "bytes_per_s": 3.35e12,
                              "capacity_bytes": 80 * 2**30},
    "cpu": {"flops": 1.0e11, "bytes_per_s": 25.6e9, "capacity_bytes": None,
            "nominal": True},
}

# JAX's hand table: forward FLOPs a 224² image (2 × published GMACs), the
# analytic fallback and the cross-check.
ANALYTIC_FWD_FLOPS_PER_IMG: dict[str, float] = {
    "resnet50": 2 * 4.09e9,
    "resnet18": 2 * 1.82e9,
    "efficientnet_b0": 2 * 0.40e9,
    "regnetx_160": 2 * 15.99e9,
    "regnety_160": 2 * 15.96e9,
    "regnety_320": 2 * 32.34e9,
}

# forward + backward + update ≈ 3 × forward
TRAIN_FLOPS_MULT = 3.0

_seen_labels: set[str] = set()


def reset() -> None:
    """Forget the labels counted (a new run's sink; tests)."""
    _seen_labels.clear()


def seen(label: str) -> bool:
    return label in _seen_labels


def _host_ram_bytes() -> int | None:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def peaks_for(device) -> dict | None:
    """The peak entry of ``device``: ``{kind, flops, bytes_per_s,
    capacity_bytes, capacity_source, nominal}``, or None for a card the
    table lacks. A card's capacity is ``mem_get_info()[1]``; the CPU's the
    host's RAM."""
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    entry = DEVICE_PEAKS.get(kind)
    if entry is None:
        return None
    out = {"kind": kind, "flops": float(entry["flops"]),
           "bytes_per_s": float(entry["bytes_per_s"]),
           "capacity_bytes": entry.get("capacity_bytes"), "capacity_source": "table",
           "nominal": bool(entry.get("nominal", False))}
    if device.type == "cuda":
        out["capacity_bytes"] = int(torch.cuda.mem_get_info(device)[1])
        out["capacity_source"] = "mem_get_info"
    else:
        for env, key in (("DTPU_CPU_PEAK_FLOPS", "flops"), ("DTPU_CPU_PEAK_BW", "bytes_per_s")):
            try:
                if os.environ.get(env):
                    out[key] = float(os.environ[env])
                    out["nominal"] = False
            except ValueError:
                pass
        ram = _host_ram_bytes()
        if ram:
            out["capacity_bytes"], out["capacity_source"] = ram, "host-ram"
    return out


def analytic_step_flops(arch: str, images: int, train: bool = True) -> float | None:
    """The hand table's flops a step of ``images`` images, or None."""
    fwd = ANALYTIC_FWD_FLOPS_PER_IMG.get(arch)
    if fwd is None or images <= 0:
        return None
    return fwd * images * (TRAIN_FLOPS_MULT if train else 1.0)


def mfu_value(flops_per_step: float, step_seconds: float,
              total_peak_flops: float) -> float | None:
    """Model-flops utilization of one step."""
    if not (flops_per_step and step_seconds and total_peak_flops):
        return None
    if step_seconds <= 0 or total_peak_flops <= 0:
        return None
    return flops_per_step / step_seconds / total_peak_flops


def roofline_point(flops: float | None, bytes_accessed: float | None,
                   peaks: dict | None) -> dict | None:
    """Arithmetic intensity against the device's ridge: which roof bounds
    the step. None without flops; no verdict without a peak entry."""
    if not flops:
        return None
    out = {"arithmetic_intensity": None, "ridge_intensity": None, "bound": None}
    if bytes_accessed:
        out["arithmetic_intensity"] = flops / bytes_accessed
    if peaks and peaks.get("flops") and peaks.get("bytes_per_s"):
        out["ridge_intensity"] = peaks["flops"] / peaks["bytes_per_s"]
        if out["arithmetic_intensity"] is not None:
            out["bound"] = ("compute" if out["arithmetic_intensity"] >= out["ridge_intensity"]
                            else "memory")
    return out


# ------------------------------------------------------------- counting
def _meta_memo(obj, memo: dict, depth: int = 0) -> None:
    """Meta stand-ins, in ``memo``, for the tensors ``obj`` holds (itself,
    in a list, tuple or dict, or in an object's attributes two levels
    down), so a deepcopy copies no tensor data."""
    if torch.is_tensor(obj):
        if id(obj) not in memo:
            t = torch.empty_like(obj, device="meta")
            if isinstance(obj, torch.nn.Parameter):
                t = torch.nn.Parameter(t, requires_grad=obj.requires_grad)
            memo[id(obj)] = t
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _meta_memo(v, memo, depth)
    elif isinstance(obj, dict):
        for v in obj.values():
            _meta_memo(v, memo, depth)
    elif depth < 2 and hasattr(obj, "__dict__") and not isinstance(obj, torch.nn.Module):
        for v in vars(obj).values():
            _meta_memo(v, memo, depth + 1)


def meta_copy(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` copied onto the meta device: the same structure, mode
    and dtypes, every parameter, buffer and cached tensor a meta tensor
    of its shape. Reads the live module's metadata only."""
    memo: dict = {}
    for m in module.modules():
        for v in vars(m).values():
            _meta_memo(v, memo)
    return copy.deepcopy(module, memo)


def _tensors(items):
    """The tensors among ``items`` (an op's args, kwargs values or
    outputs), one list or tuple level down."""
    for x in items:
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (t for t in x if torch.is_tensor(t))


def _nbytes(items) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(items))


def _on_meta(items) -> bool:
    return any(t.device.type == "meta" for t in _tensors(items))


def _conv_backward_flops(args) -> int | None:
    """A (non-transposed) convolution's backward: its forward's FLOPs once
    for each gradient it computes (``output_mask``: input, weight).
    ``torch.utils.flop_counter``'s formula ignores ``groups`` there and
    would count a grouped conv's backward G times over (a depthwise one's
    C times). None for a transposed conv (the formula stands)."""
    grad_out, weight, transposed, mask = args[0], args[2], args[7], args[10]
    if transposed:
        return None
    fwd = 2 * grad_out.numel() * math.prod(weight.shape[1:])
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


def _op_counter_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class OpCounter(TorchDispatchMode):
        """Adds each meta aten op's FLOPs (``torch.utils.flop_counter``'s
        formulas) and its operand and output bytes (views: none); a
        composite op is counted as the ops it decomposes into."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func.overloadpacket
            if packet not in flop_registry and func.has_kernel_for_dispatch_key(_COMPOSITE):
                # an op autograd did not decompose (inference mode) is
                # counted as its parts, as FlopCounterMode does
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            if _on_meta(outs) or _on_meta(args):
                self.ops += 1
                flops = (_conv_backward_flops(args)
                         if packet is torch.ops.aten.convolution_backward else None)
                fn = flop_registry.get(packet)
                if flops is None and fn is not None:
                    flops = fn(*args, **kwargs, out_val=out)
                self.flops += int(flops or 0)
                if not getattr(func, "is_view", False):
                    self.bytes += _nbytes(args) + _nbytes(kwargs.values()) + _nbytes(outs)
            return out

    return OpCounter


def count(fn) -> dict:
    """``fn()`` run under :class:`OpCounter`: ``{"flops", "bytes_accessed",
    "ops"}``. ``fn`` works on meta tensors (:func:`meta_copy`)."""
    from distribuuuu_tpu_torch.ops import cuda as kernel_tier

    counter = _op_counter_class()()
    with kernel_tier.counting(), counter:
        fn()
    return {"flops": float(counter.flops), "bytes_accessed": float(counter.bytes) or None,
            "ops": counter.ops}


# ------------------------------------------------------------ the ledger
def build_ledger(label: str, phase: str, cost: dict | None, memory: dict | None, *,
                 images: int, steps_per_call: int = 1, arch: str | None = None,
                 peaks: dict | None = None, n_devices: int = 1) -> dict:
    """The three record payloads (``step``/``memory``/``roofline``) from a
    count (``cost``: ``flops``, ``bytes_accessed`` a step; None: the hand
    table) and a graph's measured memory (``memory``: ``total_bytes``, or
    None). Pure, as JAX's."""
    spc = max(1, int(steps_per_call))
    if cost is not None:
        source, flops, bytes_acc = "dispatch", cost["flops"], cost.get("bytes_accessed")
    else:
        source = "analytic"
        flops = analytic_step_flops(arch or "", images, train=(phase == "train"))
        bytes_acc = None
    total_peak = peaks["flops"] * n_devices if peaks and peaks.get("flops") else None
    step_rec = {
        "v": SCHEMA, "label": label, "phase": phase,
        "flops": round(flops, 1) if flops else None,
        "bytes_accessed": round(bytes_acc, 1) if bytes_acc else None,
        "transcendentals": 0.0,
        "images": int(images), "steps_per_call": spc, "devices": int(n_devices),
        "device_kind": peaks["kind"] if peaks else None,
        "peak_flops": total_peak, "source": source,
    }
    roof = roofline_point(flops, bytes_acc, peaks)
    roof_rec = None
    if roof is not None:
        roof_rec = {
            "v": SCHEMA, "label": label, "phase": phase,
            "arithmetic_intensity": (round(roof["arithmetic_intensity"], 3)
                                     if roof["arithmetic_intensity"] else None),
            "ridge_intensity": (round(roof["ridge_intensity"], 3)
                                if roof["ridge_intensity"] else None),
            "bound": roof["bound"],
            "peak_flops": peaks["flops"] if peaks else None,
            "peak_bytes_per_s": peaks["bytes_per_s"] if peaks else None,
            "nominal_peaks": bool(peaks.get("nominal")) if peaks else None,
            "source": source,
        }
    mem_rec = None
    if memory is not None:
        capacity = peaks.get("capacity_bytes") if peaks else None
        headroom = (round((1.0 - memory["total_bytes"] / capacity) * 100, 2)
                    if capacity else None)
        mem_rec = {"v": SCHEMA, "label": label, "phase": phase, **memory,
                   "capacity_bytes": capacity,
                   "capacity_source": peaks.get("capacity_source") if peaks else None,
                   "headroom_pct": headroom, "source": "graph"}
    return {"step": step_rec, "memory": mem_rec, "roofline": roof_rec}


def capture_step(work, *, label: str, phase: str, images: int, device,
                 steps_per_call: int = 1, arch: str | None = None,
                 memory_only: bool = False) -> dict | None:
    """Count ``work`` (a no-argument function over meta tensors: one
    step) once per ``label`` and emit ``cost.step`` and ``cost.roofline``
    (nothing under ``memory_only``: a folded call's flops are its step's).
    Returns the ledger, or None when the sink is closed or the label was
    counted. A count that fails falls back to the hand table (``source
    "analytic"``), with a warning."""
    from distribuuuu_tpu_torch.telemetry import spans

    if not spans.enabled() or label in _seen_labels:
        return None
    _seen_labels.add(label)
    if memory_only:
        return None
    cost = None
    try:
        cost = count(work)  # in the caller's grad mode: a train step's backward needs it
    except Exception as e:  # noqa: BLE001 — the hand table stands in
        from distribuuuu_tpu_torch.utils.logger import get_logger

        get_logger().warning("cost count for %r failed (%s: %s): the hand table stands in",
                             label, type(e).__name__, e)
    ledger = build_ledger(label, phase, cost, None, images=images,
                          steps_per_call=steps_per_call, arch=arch, peaks=peaks_for(device))
    spans.emit_event("cost.step", **ledger["step"])
    if ledger["roofline"] is not None:
        spans.emit_event("cost.roofline", **ledger["roofline"])
    return ledger


def capture_memory(graph, *, label: str, phase: str, device) -> dict | None:
    """``cost.memory`` of ``graph`` (a ``graphs.StepGraph`` after its
    first call) once per ``label``: its first call's peak against the
    card's capacity. None on the CPU (no graph), with the sink closed or
    ``TELEMETRY.COSTMODEL_MEMORY`` off."""
    from distribuuuu_tpu_torch.config import cfg
    from distribuuuu_tpu_torch.telemetry import spans

    key = f"{label}/memory"
    peak = getattr(graph, "first_call_peak", None)
    if (not spans.enabled() or not cfg.TELEMETRY.COSTMODEL_MEMORY or peak is None
            or key in _seen_labels):
        return None
    _seen_labels.add(key)
    rec = build_ledger(label, phase, None, {"total_bytes": int(peak)}, images=0,
                       peaks=peaks_for(device))["memory"]
    spans.emit_event("cost.memory", **rec)
    return rec
