"""The port's kernel tier: hand-written CUDA kernels for Hopper (sm_90a).

Counterpart of ``distribuuuu_tpu/ops/pallas/`` and the Pallas kernels of
``distribuuuu_tpu/ops/flash_attention.py``. The kernels so far:

* ``conv_epilogue`` — fused 1x1 conv + folded eval BatchNorm + activation
  (``csrc/conv_epilogue.cu``), the eval/serve path's pointwise convs;
* ``opt_update`` — the fused optimizer update (``csrc/opt_update.cu``),
  one launch per training step over every parameter;
* ``flash_attention`` — the flash-attention forward, dQ and dK/dV
  (``csrc/flash_attention.cu``), the ViT's attention under
  ``DEVICE.ATTN_IMPL flash`` (or ``auto`` at 1024 tokens or more);
* ``decode_attn`` — attention of one new token over the paged KV cache
  (``csrc/decode_attn.cu``), every T=1 step of LM generation;
* ``group_conv`` — the grouped 3x3 "same" conv (``csrc/group_conv.cu``),
  forward and stride-1 dx, at the grouped sites ``DISTRIBUUUU_GROUP_CONV=
  pallas`` routes to it (3x3, stride 1, at most 14², as in JAX: the
  RegNets' stage 3 at 224²).

Which implementation runs is decided in ONE place, :func:`use_kernel`
(:func:`choose` records the choice), and only by where the tensor lives: a CUDA tensor goes through the kernel or
the call raises; a CPU tensor goes through the kernel's plain PyTorch
version (the tests' path). There is no knob that sends a CUDA tensor to
the plain version and no forced-but-unsupported fallback. A call site that
does not qualify for a kernel (stride 2, a 3x3, groups, training; dense
attention under ``DEVICE.ATTN_IMPL xla``; an LM prefill, or a cache tile
that ``KERNELS.DECODE_BLOCK`` does not divide; a grouped conv under another
``DISTRIBUUUU_GROUP_CONV`` value, or larger than 14²) runs the plain layer,
as the JAX package does; that is the site's shape, not a fallback.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# KERNELS.* knobs the port keeps. "auto" is the only value: kernel on CUDA
# tensors, plain version on CPU tensors.
VALID_IMPLS = ("auto",)
KNOBS = {"conv_epilogue": "CONV_EPILOGUE", "opt_update": "OPT_UPDATE",
         "decode_attn": "DECODE_ATTN"}


def validate_kernels_cfg(kcfg) -> None:
    """Refuse any KERNELS.* value other than ``auto``, and a
    ``KERNELS.DECODE_BLOCK`` that is not a positive multiple of 8 (the JAX
    package's rule, so a config means the same tiles in both)."""
    for op, knob in KNOBS.items():
        v = kcfg[knob]
        if v not in VALID_IMPLS:
            raise ValueError(
                f"KERNELS.{knob}={v!r}: the port accepts only {list(VALID_IMPLS)} "
                f"for the {op} kernel (the kernel on CUDA tensors, its plain "
                "version on CPU tensors); a CUDA tensor never takes the plain path"
            )
    blk = int(kcfg.DECODE_BLOCK)
    if blk < 8 or blk % 8:
        raise ValueError(
            f"KERNELS.DECODE_BLOCK={blk} must be a positive multiple of 8: "
            f"{blk} % 8 = {blk % 8} — the block height of the TPU decode "
            "kernel, kept so that the same GENERATE.CACHE_TILES take the kernel"
        )


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel, False when it goes
    through the plain version (a CPU tensor; a meta tensor while the cost
    ledger counts, :func:`counting`). Other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu" or (t.device.type == "meta" and getattr(_local, "counting", False)):
        return False
    raise RuntimeError(
        f"no kernel or plain version for tensors on {t.device}: the port "
        "runs on CUDA, and on the CPU only for tests"
    )


def choose(t: torch.Tensor, op: str) -> bool:
    """:func:`use_kernel` for kernel ``op``, the choice recorded: the
    first for ``op`` in a run lands one ``kind="kernel.select"`` record
    (``impl`` ``"cuda"`` or ``"plain"``, ``requested`` ``"auto"``); the
    port has no fallback, so it writes no ``kernel.fallback``."""
    kernel = use_kernel(t)
    if t.device.type != "meta":
        note_select(op, "cuda" if kernel else "plain")
    return kernel


_local = threading.local()


@contextlib.contextmanager
def counting():
    """Meta tensors take the plain versions inside (this thread): the cost
    ledger counts a step's work on the meta device
    (``telemetry/costmodel.py``)."""
    prev = getattr(_local, "counting", False)
    _local.counting = True
    try:
        yield
    finally:
        _local.counting = prev


_selected: set = set()


def reset_selected() -> None:
    """Forget the choices recorded (a new run's telemetry sink)."""
    _selected.clear()


def note_select(op: str | None, impl: str) -> None:
    """One ``kind="kernel.select"`` record per (op, impl) and run (the
    telemetry sink's life), once the sink is open: :func:`use_kernel`'s choice, or a
    site whose shape runs the plain layer (``impl "plain"``; JAX's
    ``select`` records such a site as ``"xla"``)."""
    if op is None or (op, impl) in _selected:
        return
    from distribuuuu_tpu_torch.telemetry import spans

    if not spans.enabled():
        return
    _selected.add((op, impl))
    spans.emit_event("kernel.select", op=op, impl=impl, requested="auto")


# (module, attribute holding the count) of every kernel wrapper's launch
# counter; a function's counter is an attribute of the function
_COUNTERS = {
    "conv_epilogue": ("conv_epilogue", "conv1x1_bn_act.launches"),
    "opt_update": ("opt_update", "update.launches"),
    "flash_forward": ("flash_attention", "fwd_launches"),
    "flash_dq": ("flash_attention", "dq_launches"),
    "flash_dkdv": ("flash_attention", "dkdv_launches"),
    "decode_attn": ("decode_attn", "launches"),
    "group_conv": ("group_conv", "group_conv3x3.launches"),
    "group_conv_dx": ("group_conv", "group_conv3x3.launches_dx"),
}


def _counter(key: str):
    """(object holding the count, attribute name) of one counter."""
    import importlib

    mod, path = _COUNTERS[key]
    obj = importlib.import_module(f"{__name__}.{mod}")
    *owners, attr = path.split(".")
    for name in owners:
        obj = getattr(obj, name)
    return obj, attr


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel."""
    return {k: getattr(*_counter(k)) for k in _COUNTERS}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta[k]`` to kernel k's launch count (a graph's replay adds
    the launches it captured)."""
    for k, n in delta.items():
        if n:
            obj, attr = _counter(k)
            setattr(obj, attr, getattr(obj, attr) + n)
