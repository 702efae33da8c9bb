"""Weight-only quantized serving (counterpart of
distribuuuu_tpu/serve/quantize.py, the same modes, tolerances and bytes).

* ``bf16``: every float weight leaf, the BN running statistics included,
  is held in bfloat16 (half the bytes) and widened to f32 in the graph,
  where the model's own eval path casts it to the compute dtype as it
  casts an f32 master. (JAX folds the BN in the leaves' bf16 there:
  ``rsqrt(var + eps) * scale`` keeps their dtype; the port folds the
  widened values in f32, within 2e-3 of JAX's logit scale on the tests'
  toy RegNet.)
* ``int8``: every float leaf with at least two dims and MIN_INT8_SIZE
  elements is held as symmetric per-output-channel int8 with an f32
  scale (a quarter of the bytes) and dequantized in the graph; the rest
  stay f32.

JAX scales its leaves on their LAST axis (a conv's HWIO → O, a dense
``(in, out)`` → out). The port holds the same tensors in its own layout
(``utils/weights._port_layout``): a conv weight OIHW and a ``Linear``
weight ``[out, in]`` carry that axis first, a tensor kept as JAX has it
(``pos_embed``, the cls token, the tables of ``weights.TABLES``) last.
Both sides round half to even, clip at ±127 and take a zero scale as 1,
so the packed int8 and the scales are JAX's bit for bit after the layout
transposition.

In the graph the dequant is plain PyTorch, as it is plain XLA in JAX, in
a few launches over all the packed leaves: the int8 leaves whose output
channels run the same length sit side by side in one int8 buffer a
group (one multiply a group widens them to f32), and every bf16 leaf sits
in one buffer (one cast). The resulting tensors take the place of the
model's weights and the model's ``prepare()`` (the BN fold and the casts
to the compute dtype) runs after them, in the same graph, every replay.
The only resident copy of a quantized weight is the packed one.
"""

from __future__ import annotations

import numpy as np
import torch

from distribuuuu_tpu_torch.utils.weights import TABLES

MODES = ("bf16", "int8")
# relative logits tolerance per mode: max|logits_q - logits_f32| over
# max|logits_f32|, JAX's pin
TOLERANCE = {"bf16": 0.02, "int8": 0.08}
# leaves smaller than this stay f32 under int8
MIN_INT8_SIZE = 256


def _leaves(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's tensors that are leaves of JAX's variables tree: every
    parameter and buffer but the BN step counters."""
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def channel_axis(key: str, ndim: int) -> int:
    """The port-layout axis of JAX's last axis for the tensor ``key``."""
    if ndim == 4 or (ndim == 2 and not key.endswith(TABLES)):
        return 0
    return ndim - 1


def quantize_int8(x: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 with one f32 scale per index of ``axis`` (JAX's
    ``_quantize_leaf_int8`` over that axis)."""
    x = np.asarray(x, np.float32)
    absmax = np.max(np.abs(x), axis=tuple(a for a in range(x.ndim) if a != axis),
                    keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, np.float32(1.0), scale)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_state(model: torch.nn.Module, mode: str):
    """``(packed, meta)``: ``packed`` maps each quantized tensor's key to
    ``("int8", q, scale, axis)`` or ``("bf16", t)`` (host tensors), and
    ``meta`` is JAX's ``{mode, bytes_before, bytes_after, leaves,
    quantized_leaves}`` for the same model."""
    if mode not in MODES:
        raise ValueError(f"SERVE.QUANTIZE must be one of {MODES} (or empty), got {mode!r}")
    meta = {"mode": mode, "bytes_before": 0, "bytes_after": 0, "leaves": 0,
            "quantized_leaves": 0}
    packed = {}
    for key, t in _leaves(model).items():
        t = t.detach().cpu()
        n = t.numel() * t.element_size()
        meta["leaves"] += 1
        meta["bytes_before"] += n
        if not t.is_floating_point():
            meta["bytes_after"] += n
            continue
        if mode == "bf16":
            meta["quantized_leaves"] += 1
            meta["bytes_after"] += n // 2
            packed[key] = ("bf16", t.to(torch.bfloat16))
        elif t.dim() >= 2 and t.numel() >= MIN_INT8_SIZE:
            axis = channel_axis(key, t.dim())
            q, scale = quantize_int8(t.float().numpy(), axis)
            meta["quantized_leaves"] += 1
            meta["bytes_after"] += q.nbytes + scale.nbytes
            packed[key] = ("int8", torch.from_numpy(q), torch.from_numpy(scale), axis)
        else:
            meta["bytes_after"] += n
    return packed, meta


def dequantize_state(packed: dict) -> dict[str, torch.Tensor]:
    """The f32 tensors of ``quantize_state``'s output, leaf by leaf (the
    reference the graphed dequant is held to)."""
    out = {}
    for key, p in packed.items():
        out[key] = p[1].float() if p[0] == "bf16" else p[1].float() * p[2]
    return out


class Packed:
    """The packed weights of one model on its device, grouped for a dequant
    of a few launches (module docstring), and the binding of the dequant's
    output into the model in place of its weights."""

    def __init__(self, model: torch.nn.Module, packed: dict, device):
        self.model = model
        self.keys = list(packed)
        leaves = _leaves(model)
        self.shapes = {k: tuple(leaves[k].shape) for k in self.keys}
        self.dtypes = {k: leaves[k].dtype for k in self.keys}
        groups: dict[tuple, list] = {}
        bf16 = []
        for key, p in packed.items():
            if p[0] == "bf16":
                bf16.append((key, p[1].reshape(-1)))
                continue
            _, q, scale, axis = p
            if axis == 0:  # [channels, run]: one int8 row per channel
                groups.setdefault(("row", q[0].numel()), []).append((key, q, scale))
            else:  # a scale per last-axis index: a group of its own
                groups[("last", key)] = [(key, q, scale)]
        self.groups = []  # (int8 rows or leaf, its scales, keys, whether rows)
        for (kind, _), items in groups.items():
            rows = kind == "row"
            if rows:
                q = torch.cat([q.reshape(q.shape[0], -1) for _, q, _ in items])
                s = torch.cat([s.reshape(-1, 1) for _, _, s in items])
            else:
                (_, q, s), = items
            self.groups.append((q.to(device), s.to(device), [k for k, _, _ in items], rows))
        self.bf16 = (torch.cat([t for _, t in bf16]).to(device) if bf16 else None,
                     [k for k, _ in bf16])
        self.resident_bytes = sum(q.numel() + s.numel() * 4 for q, s, _, _ in self.groups)
        if self.bf16[0] is not None:
            self.resident_bytes += self.bf16[0].numel() * 2
        for key in self.keys:  # drop the full-precision copies
            self._set(key, torch.empty(0, dtype=self.dtypes[key], device=device))

    def _set(self, key: str, t: torch.Tensor) -> None:
        mod_name, _, name = key.rpartition(".")
        mod = self.model.get_submodule(mod_name)
        if name in mod._parameters:
            mod._parameters[name] = t
        else:
            mod._buffers[name] = t

    def dequantize(self) -> dict[str, torch.Tensor]:
        """f32 tensors of every packed leaf: one multiply an int8 group, one
        cast for all bf16 leaves."""
        out = {}
        for q, s, keys, rows in self.groups:
            full = q * s  # int8 times f32: f32, one launch
            if not rows:
                out[keys[0]] = full
                continue
            at = 0
            for key in keys:
                shape = self.shapes[key]
                out[key] = full[at:at + shape[0]].reshape(shape)
                at += shape[0]
        flat, keys = self.bf16
        if flat is not None:
            wide, at = flat.float(), 0
            for key in keys:
                n = int(np.prod(self.shapes[key], dtype=np.int64))
                out[key] = wide[at:at + n].reshape(self.shapes[key])
                at += n
        return out

    def bind(self) -> None:
        """Dequantize, put the tensors in the model in place of its weights
        and rebuild its eval caches (``prepare()``): the head of every
        quantized forward."""
        for key, t in self.dequantize().items():
            self._set(key, t.to(self.dtypes[key]))
        self.model.prepare()


def quantized_delta(model: torch.nn.Module, images: torch.Tensor, mode: str) -> dict:
    """JAX's accuracy referee on the port: ``images`` through ``model`` (f32
    weights, eval) and through the ``mode`` variant of the same weights;
    the relative logits delta and top-1 agreement against TOLERANCE. The
    model's weights are restored before it returns."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        ref = model.eval().prepare()(images).float()
        packed, meta = quantize_state(model, mode)
        deq = dequantize_state(packed)
        model.load_state_dict({**state, **{k: v.to(state[k].dtype) for k, v in deq.items()}})
        got = model.prepare()(images).float()
        model.load_state_dict(state)
        model.prepare()
    denom = max(float(ref.abs().max()), 1e-9)
    rel = float((got - ref).abs().max()) / denom
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return {
        "mode": mode,
        "rel_logits_delta": round(rel, 6),
        "tolerance": TOLERANCE[mode],
        "top1_agree": round(agree, 4),
        "ok": rel <= TOLERANCE[mode],
        "bytes_before": meta["bytes_before"],
        "bytes_after": meta["bytes_after"],
        "quantized_leaves": meta["quantized_leaves"],
    }
