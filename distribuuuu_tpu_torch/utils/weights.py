"""Carrying weights into the port.

* :func:`state_dict_from_jax` maps the JAX ResNet's, RegNet's, ViT's or
  GPT's variables (``params`` and ``batch_stats`` as nested dicts of numpy
  arrays, boxed leaves taken by their ``.value``; a ViT or GPT has no
  ``batch_stats``) onto the port's torchvision/timm-named state dict:
  conv ``[kh, kw, I, O]`` → ``[O, I, kh, kw]`` (an SE conv's bias as it
  is), dense ``[I, O]`` →
  ``[O, I]`` (qkv keeps its ``(3, heads, head_dim)`` column order), BN
  ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``, LayerNorm ``scale`` → ``weight``,
  ``pos_embed`` and the token ``embedding`` ``[vocab, dim]`` as they are.
* :func:`opt_state_from_jax` maps the optax state of the JAX package's
  ``construct_optimizer()`` onto the port's optimizer state
  (``utils/optim.Optimizer.load_state_dict``): the trace, or mu and nu,
  by the same paths, plus the step count.
* :func:`load_weights` loads a torch ``.pth``/``.pth.tar`` (a state dict, a
  ``{"state_dict": ...}`` wrapper or a port checkpoint's ``{"model": ...}``,
  ``module.`` prefixes stripped).

An orbax directory (JAX's checkpoint format) and the pretrained URL zoo
(``MODEL.PRETRAINED``, which needs the network) are refused.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from distribuuuu_tpu_torch import not_ported

# flax block module -> the number of its main ConvBNs (a further one is
# the downsample)
_BLOCK_CONVS = {"BasicBlock": 2, "Bottleneck": 3}
# the GPT's token table: [vocab, dim] in both frameworks, not transposed
EMBEDDING = "tok_embed.weight"


def _idx(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _sorted(names, prefix):
    return sorted((n for n in names if re.fullmatch(rf"{prefix}_\d+", n)), key=_idx)


def _vit_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The ViT tree: ``Conv_0`` (patch embed), ``pos_embed``, ``Block_N``
    with ``LayerNorm_0/1``, ``Attention_0/Dense_{0,1}/Dense_0`` (qkv, proj)
    and ``Mlp_0/Dense_{0,1}/Dense_0`` (fc1, fc2), ``LayerNorm_0`` (the
    final norm) and ``Dense_0/Dense_0`` (the head). The GPT tree (told
    apart by ``tok_embed``) has ``tok_embed/embedding`` in place of the
    patch conv and ``head/Dense_0`` for the head, the rest alike."""
    out: dict[tuple[str, ...], str] = {("pos_embed",): "pos_embed"}
    gpt = "tok_embed" in params

    def dense(prefix, key):
        out[(*prefix, "Dense_0", "kernel")] = f"{key}.weight"
        out[(*prefix, "Dense_0", "bias")] = f"{key}.bias"

    def norm(prefix, key):
        out[(*prefix, "scale")] = f"{key}.weight"
        out[(*prefix, "bias")] = f"{key}.bias"

    if gpt:
        out[("tok_embed", "embedding")] = EMBEDDING
    else:
        out[("Conv_0", "kernel")] = "patch_embed.proj.weight"
        out[("Conv_0", "bias")] = "patch_embed.proj.bias"
    for blk in _sorted(params, "Block"):
        base = f"blocks.{_idx(blk)}"
        norm((blk, "LayerNorm_0"), f"{base}.norm1")
        dense((blk, "Attention_0", "Dense_0"), f"{base}.attn.qkv")
        dense((blk, "Attention_0", "Dense_1"), f"{base}.attn.proj")
        norm((blk, "LayerNorm_1"), f"{base}.norm2")
        dense((blk, "Mlp_0", "Dense_0"), f"{base}.mlp.fc1")
        dense((blk, "Mlp_0", "Dense_1"), f"{base}.mlp.fc2")
    norm(("LayerNorm_0",), "norm")
    dense(("head",) if gpt else ("Dense_0",), "head")
    return out


def _convbn(out: dict, jax_prefix, conv_key: str, bn_key: str) -> None:
    """One flax ConvBN: ``Conv_0/kernel`` and ``BatchNorm_0/BatchNorm_0``'s
    scale, bias and running mean and var."""
    out[(*jax_prefix, "Conv_0", "kernel")] = f"{conv_key}.weight"
    bn = (*jax_prefix, "BatchNorm_0", "BatchNorm_0")
    out[(*bn, "scale")] = f"{bn_key}.weight"
    out[(*bn, "bias")] = f"{bn_key}.bias"
    out[(*bn, "mean")] = f"{bn_key}.running_mean"
    out[(*bn, "var")] = f"{bn_key}.running_var"


def _regnet_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The RegNet tree: ``ConvBN_0`` (the stem), ``RegNetBlock_N`` numbered
    over the whole net, each with ``ConvBN_0..3`` where it has a downsample
    (then ``ConvBN_0`` IS the downsample, created first) or ``ConvBN_0..2``,
    and ``SqueezeExcite_0/Conv_{0,1}/{kernel,bias}`` in a Y block, and
    ``Dense_0/Dense_0`` (the head). Every stage opens with a downsample
    block."""
    out: dict[tuple[str, ...], str] = {}

    def convbn(prefix, key):
        _convbn(out, prefix, f"{key}.conv", f"{key}.bn")

    convbn(("ConvBN_0",), "stem")
    stage, pos = 0, 0
    for blk in _sorted(params, "RegNetBlock"):
        convs = _sorted(params[blk], "ConvBN")
        if len(convs) == 4:
            stage, pos = stage + 1, 0
            convbn((blk, convs.pop(0)), f"s{stage}.b1.downsample")
        pos += 1
        base = f"s{stage}.b{pos}"
        for i, name in enumerate(convs):
            convbn((blk, name), f"{base}.conv{i + 1}")
        if "SqueezeExcite_0" in params[blk]:
            for i in (0, 1):
                for leaf in ("kernel", "bias"):
                    out[(blk, "SqueezeExcite_0", f"Conv_{i}", leaf)] = (
                        f"{base}.se.fc{i + 1}.{'weight' if leaf == 'kernel' else 'bias'}")
    out[("Dense_0", "Dense_0", "kernel")] = "head.fc.weight"
    out[("Dense_0", "Dense_0", "bias")] = "head.fc.bias"
    return out


def jax_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """``{flax path: port state-dict key}`` for every leaf of a JAX ResNet's
    or RegNet's ``params`` and ``batch_stats`` trees, or of a JAX ViT's or
    GPT's ``params`` (told apart by their top-level ``pos_embed``; a RegNet
    by its ``RegNetBlock_*``). ResNet stages are found
    from the tree: a block with a downsample ConvBN opens a new stage
    (stage 1 of the BasicBlock nets has none, and block 0 always opens
    stage 1)."""
    if "pos_embed" in params:
        return _vit_path_map(params)
    if _sorted(params, "RegNetBlock"):
        return _regnet_path_map(params)
    out: dict[tuple[str, ...], str] = {}
    stems = _sorted(params, "ConvBN")
    if stems != ["ConvBN_0"]:
        raise ValueError(f"not a JAX ResNet tree: top-level ConvBNs {stems}")
    _convbn(out, ("ConvBN_0",), "conv1", "bn1")
    kinds = [k for k in _BLOCK_CONVS if _sorted(params, k)]
    if len(kinds) != 1:
        raise ValueError(f"not a JAX ResNet tree: block kinds {kinds}")
    kind = kinds[0]
    n_main = _BLOCK_CONVS[kind]
    stage, pos = 0, 0
    for blk in _sorted(params, kind):
        convs = _sorted(params[blk], "ConvBN")
        down = len(convs) == n_main + 1
        if _idx(blk) == 0 or down:
            stage, pos = stage + 1, 0
        base = f"layer{stage}.{pos}"
        for i, name in enumerate(convs[:n_main]):
            _convbn(out, (blk, name), f"{base}.conv{i + 1}", f"{base}.bn{i + 1}")
        if down:
            _convbn(out, (blk, convs[-1]), f"{base}.downsample.0", f"{base}.downsample.1")
        pos += 1
    out[("Dense_0", "Dense_0", "kernel")] = "fc.weight"
    out[("Dense_0", "Dense_0", "bias")] = "fc.bias"
    return out


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), getattr(v, "value", v)


def _port_layout(arr, dtype=np.float32, key: str = "") -> np.ndarray:
    a = np.asarray(arr, dtype)
    if a.ndim == 4:  # conv HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2 and key != EMBEDDING:  # dense [I, O] -> [O, I]
        a = a.T
    return np.ascontiguousarray(a)


def state_dict_from_jax(params: dict, batch_stats: dict | None = None
                        ) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX ResNet's, ViT's or GPT's variables
    (numpy leaves; a ViT's or GPT's ``batch_stats`` is empty or None).
    Every leaf lands in exactly one tensor; an unmapped leaf raises."""
    paths = jax_path_map(params)
    sd: dict[str, torch.Tensor] = {}
    for path, arr in [*_leaves(params), *_leaves(batch_stats or {})]:
        if path not in paths:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no port tensor")
        sd[paths[path]] = torch.from_numpy(_port_layout(arr, key=paths[path]))
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key.replace("running_var", "num_batches_tracked")] = torch.zeros((), dtype=torch.long)
    return sd


def _find(state, field: str):
    """The first namedtuple in a nested optax state that has ``field``."""
    if hasattr(state, "_fields"):
        if field in state._fields:
            return state
        state = tuple(getattr(state, f) for f in state._fields)
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find(sub, field)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, params: dict) -> dict:
    """The port's optimizer state (``Optimizer.load_state_dict``) for the
    optax state of the JAX package's ``construct_optimizer()`` over a JAX
    ResNet's ``params``: ``{"count", "m", "v"}`` with ``m`` the SGD trace or
    AdamW's mu and ``v`` AdamW's nu, as numpy arrays under the port's
    parameter names (``None`` where the optimizer keeps none). ``count`` is
    the number of steps taken (AdamW's own counter where it has one).
    Arrays are f32 (f64 where the state is f64; a bf16 trace is exact in
    f32)."""
    paths = jax_path_map(params)

    def tree(t):
        if t is None:
            return None
        return {paths[p]: _port_layout(a, np.float64 if np.asarray(a).dtype == np.float64
                                       else np.float32) for p, a in _leaves(t)}

    adam = _find(opt_state, "mu")
    if adam is not None:
        return {"count": int(np.asarray(adam.count)), "m": tree(adam.mu), "v": tree(adam.nu)}
    trace = _find(opt_state, "trace")
    return {"count": int(np.asarray(opt_state.count)),
            "m": tree(trace.trace) if trace is not None else None, "v": None}


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a torch ``.pth``/``.pth.tar`` into ``model`` (strict)."""
    if os.path.isdir(path):
        raise not_ported(
            f"MODEL.WEIGHTS={path!r} is a directory (an orbax checkpoint, JAX's "
            "format); the port loads torch .pth files. Loading orbax checkpoints",
            "Orbax weights",
        )
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj.get("model", obj)) if isinstance(obj, dict) else obj
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    return model


def pretrained_refusal(arch: str) -> NotImplementedError:
    """MODEL.PRETRAINED fetches from the URL zoo, which needs the network."""
    return NotImplementedError(
        f"MODEL.PRETRAINED for {arch!r} downloads weights from the URL zoo and "
        "the port does not fetch from the network; download the .pth yourself "
        "and pass it as MODEL.WEIGHTS"
    )
