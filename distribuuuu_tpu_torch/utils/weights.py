"""Carrying weights into the port.

* :func:`state_dict_from_jax` maps the JAX ResNet's, RegNet's,
  DenseNet's, EfficientNet's, BoTNet's, ViT's or GPT's variables
  (``params`` and ``batch_stats`` as nested dicts of numpy arrays, boxed
  leaves taken by their ``.value``; a ViT or GPT has no ``batch_stats``)
  onto the port's torchvision/timm-named state dict: conv ``[kh, kw, I,
  O]`` → ``[O, I, kh, kw]`` (an SE conv's bias as it is), dense ``[I, O]``
  → ``[O, I]`` (qkv keeps its ``(3, heads, head_dim)`` column order), BN
  ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``, LayerNorm ``scale`` → ``weight``,
  ``pos_embed``, the token ``embedding`` ``[vocab, dim]`` and BoTNet's
  ``rel_height``/``rel_width`` ``[2n-1, d]`` as they are.
* :func:`opt_state_from_jax` maps the optax state of the JAX package's
  ``construct_optimizer()`` onto the port's optimizer state
  (``utils/optim.Optimizer.load_state_dict``): the trace, or mu and nu,
  by the same paths, plus the step count.
* :func:`load_weights` loads a torch ``.pth``/``.pth.tar`` (a state dict, a
  ``{"state_dict": ...}`` wrapper or a port checkpoint's ``{"model": ...}``,
  ``module.`` prefixes stripped, torchvision's legacy DenseNet keys
  renamed), or an orbax checkpoint directory of the
  JAX package (a weights-only ``best``, a full ``ckpt_ep_NNN``, a sharded
  save), read by ``utils/orbax.py`` and mapped by
  :func:`state_dict_from_jax`.
* :func:`port_path_map` and :func:`jax_tree_from_state_dict` go the other
  way: each port key's JAX path, and the JAX ``params``/``batch_stats``
  trees of a port state dict (the sharded checkpoint's layout).

The pretrained URL zoo (``MODEL.PRETRAINED``, which needs the network) is
refused.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from distribuuuu_tpu_torch.parallel.partition import specs

# flax block module -> the number of its main ConvBNs (a further one is
# the downsample)
_BLOCK_CONVS = {"BasicBlock": 2, "Bottleneck": 3}
# the GPT's token table: [vocab, dim] in both frameworks, not transposed
EMBEDDING = "tok_embed.weight"
# a MoE layer's tensors, in the flax order; kept in the JAX layout
MOE_LEAVES = ("gate", "w_in", "b_in", "w_out", "b_out")
# 2-D leaves that are not [in, out] Dense kernels: not transposed
TABLES = (EMBEDDING, "rel_height", "rel_width", "emb_height", "emb_width",
          "mlp.gate", "mlp.b_in", "mlp.b_out")


def _idx(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _sorted(names, prefix):
    return sorted((n for n in names if re.fullmatch(rf"{prefix}_\d+", n)), key=_idx)


def _vit_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The ViT tree: ``Conv_0`` (patch embed), ``pos_embed``, ``Block_N``
    with ``LayerNorm_0/1``, ``Attention_0/Dense_{0,1}/Dense_0`` (qkv, proj)
    and ``Mlp_0/Dense_{0,1}/Dense_0`` (fc1, fc2) or, in a MoE block,
    ``MoeMlp_0/{gate, w_in, b_in, w_out, b_out}`` (``mlp.*``, in the JAX
    layout), ``LayerNorm_0`` (the final norm) and ``Dense_0/Dense_0`` (the
    head). The GPT tree (told apart by ``tok_embed``) has
    ``tok_embed/embedding`` in place of the patch conv and ``head/Dense_0``
    for the head, the rest alike."""
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
        if "MoeMlp_0" in params[blk]:
            for leaf in MOE_LEAVES:
                out[(blk, "MoeMlp_0", leaf)] = f"{base}.mlp.{leaf}"
        else:
            dense((blk, "Mlp_0", "Dense_0"), f"{base}.mlp.fc1")
            dense((blk, "Mlp_0", "Dense_1"), f"{base}.mlp.fc2")
    norm(("LayerNorm_0",), "norm")
    dense(("head",) if gpt else ("Dense_0",), "head")
    return out


def _bn(out: dict, jax_prefix, bn_key: str) -> None:
    """One flax ``BatchNorm`` at ``jax_prefix``: its core ``BatchNorm_0``'s
    scale, bias and running mean and var."""
    bn = (*jax_prefix, "BatchNorm_0")
    out[(*bn, "scale")] = f"{bn_key}.weight"
    out[(*bn, "bias")] = f"{bn_key}.bias"
    out[(*bn, "mean")] = f"{bn_key}.running_mean"
    out[(*bn, "var")] = f"{bn_key}.running_var"


def _convbn(out: dict, jax_prefix, conv_key: str, bn_key: str) -> None:
    """One flax ConvBN: ``Conv_0/kernel`` and ``BatchNorm_0``."""
    out[(*jax_prefix, "Conv_0", "kernel")] = f"{conv_key}.weight"
    _bn(out, (*jax_prefix, "BatchNorm_0"), bn_key)


def _conv_and_bn(out: dict, jax_prefix, i: int, conv_key: str, bn_key: str) -> None:
    """A ``Conv_i`` and its ``BatchNorm_i`` side by side under ``jax_prefix``
    (EfficientNet's explicitly named pairs)."""
    out[(*jax_prefix, f"Conv_{i}", "kernel")] = f"{conv_key}.weight"
    _bn(out, (*jax_prefix, f"BatchNorm_{i}"), bn_key)


def _dense(out: dict, key: str) -> None:
    out[("Dense_0", "Dense_0", "kernel")] = f"{key}.weight"
    out[("Dense_0", "Dense_0", "bias")] = f"{key}.bias"


def _se(out: dict, jax_prefix, key: str, names=("fc1", "fc2")) -> None:
    """A flax ``SqueezeExcite``'s two convs with biases."""
    for i, name in enumerate(names):
        for leaf in ("kernel", "bias"):
            out[(*jax_prefix, "SqueezeExcite_0", f"Conv_{i}", leaf)] = (
                f"{key}.{name}.{'weight' if leaf == 'kernel' else 'bias'}")


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
            _se(out, (blk,), f"{base}.se")
    _dense(out, "head.fc")
    return out


def _densenet_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The DenseNet tree: ``Conv_0``/``BatchNorm_0`` (the stem),
    ``block{i}_layer{j}`` with ``BatchNorm_0, Conv_0, BatchNorm_1,
    Conv_1``, the transitions' ``BatchNorm_{t}``/``Conv_{t}`` (t = 1 … the
    number of blocks − 1), the last ``BatchNorm_{blocks}`` and ``Dense_0``;
    onto torchvision's ``features.*`` and ``classifier``."""
    out: dict[tuple[str, ...], str] = {("Conv_0", "kernel"): "features.conv0.weight"}
    _bn(out, ("BatchNorm_0",), "features.norm0")
    blocks = set()
    for name in params:
        m = re.fullmatch(r"block(\d+)_layer(\d+)", name)
        if m is None:
            continue
        i, j = int(m.group(1)), int(m.group(2))
        blocks.add(i)
        base = f"features.denseblock{i + 1}.denselayer{j + 1}"
        for k in (0, 1):
            _bn(out, (name, f"BatchNorm_{k}"), f"{base}.norm{k + 1}")
            out[(name, f"Conv_{k}", "kernel")] = f"{base}.conv{k + 1}.weight"
    for t in range(1, len(blocks)):
        _bn(out, (f"BatchNorm_{t}",), f"features.transition{t}.norm")
        out[(f"Conv_{t}", "kernel")] = f"features.transition{t}.conv.weight"
    _bn(out, (f"BatchNorm_{len(blocks)}",), "features.norm5")
    _dense(out, "classifier")
    return out


def _efficientnet_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The EfficientNet tree: ``Conv_0``/``BatchNorm_0`` (the stem),
    ``MBConv_0..`` with ``Conv_k``/``BatchNorm_k`` (expand, depthwise,
    project; no expand at ratio 1) and ``SqueezeExcite_0/Conv_{0,1}``,
    ``Conv_1``/``BatchNorm_1`` (the head) and ``Dense_0``; onto timm's
    names. A stage opens where a block's output width changes (every stage
    of B0 changes it)."""
    out: dict[tuple[str, ...], str] = {}
    _conv_and_bn(out, (), 0, "conv_stem", "bn1")
    stage, pos, width = -1, 0, None
    for blk in _sorted(params, "MBConv"):
        convs = _sorted(params[blk], "Conv")
        kernel = params[blk][convs[-1]]["kernel"]
        out_w = getattr(kernel, "value", kernel).shape[-1]
        stage, pos = (stage + 1, 0) if out_w != width else (stage, pos + 1)
        width, base = out_w, f"blocks.{stage}.{pos}"
        names = (["conv_pw", "conv_dw", "conv_pwl"] if len(convs) == 3
                 else ["conv_dw", "conv_pw"])
        for i, conv in enumerate(names):
            _conv_and_bn(out, (blk,), i, f"{base}.{conv}", f"{base}.bn{i + 1}")
        _se(out, (blk,), f"{base}.se", ("conv_reduce", "conv_expand"))
    _conv_and_bn(out, (), 1, "conv_head", "bn2")
    _dense(out, "classifier")
    return out


def _resnet_trunk(out: dict, params: dict) -> None:
    """A ResNet's stem (``ConvBN_0``) and its ``BasicBlock_N`` or
    ``Bottleneck_N`` stages onto torchvision's names. Stages are found
    from the tree: a block with a downsample ConvBN opens a new stage
    (stage 1 of the BasicBlock nets has none, and block 0 always opens
    stage 1)."""
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


def _botnet_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """The BoTNet tree: ResNet-50's stem and ``Bottleneck_0..12``, then
    ``BoTBlock_0..2`` (``layer4``) with ``ConvBN_0`` the shortcut where the
    block has one (created first), the reduce and last ConvBNs,
    ``MHSA2D_0/{Conv_0 (q and k), Conv_1 (v), rel_height, rel_width}`` and
    ``BatchNorm_0`` after the attention, and ``Dense_0``."""
    out: dict[tuple[str, ...], str] = {}
    _resnet_trunk(out, params)
    for blk in _sorted(params, "BoTBlock"):
        base = f"layer4.{_idx(blk)}"
        convs = _sorted(params[blk], "ConvBN")
        if len(convs) == 3:
            _convbn(out, (blk, convs.pop(0)), f"{base}.downsample.0", f"{base}.downsample.1")
        _convbn(out, (blk, convs[0]), f"{base}.conv1", f"{base}.bn1")
        _convbn(out, (blk, convs[1]), f"{base}.conv3", f"{base}.bn3")
        mhsa = (blk, "MHSA2D_0")
        out[(*mhsa, "Conv_0", "kernel")] = f"{base}.mhsa.to_qk.weight"
        out[(*mhsa, "Conv_1", "kernel")] = f"{base}.mhsa.to_v.weight"
        for table in ("rel_height", "rel_width", "emb_height", "emb_width"):
            if table in params[blk]["MHSA2D_0"]:
                out[(*mhsa, table)] = f"{base}.mhsa.{table}"
        _bn(out, (blk, "BatchNorm_0"), f"{base}.bn2")
    _dense(out, "fc")
    return out


def jax_path_map(params: dict) -> dict[tuple[str, ...], str]:
    """``{flax path: port state-dict key}`` for every leaf of a JAX CNN's
    ``params`` and ``batch_stats`` trees, or of a JAX ViT's or GPT's
    ``params``. The tree says which it is: a ViT or GPT by its top-level
    ``pos_embed``, a RegNet by its ``RegNetBlock_*``, a DenseNet by its
    ``block0_layer0``, an EfficientNet by its ``MBConv_*``, a BoTNet by
    its ``BoTBlock_*``, else a ResNet."""
    if "pos_embed" in params:
        return _vit_path_map(params)
    for marker, fn in (("RegNetBlock", _regnet_path_map), ("MBConv", _efficientnet_path_map),
                       ("BoTBlock", _botnet_path_map)):
        if _sorted(params, marker):
            return fn(params)
    if "block0_layer0" in params:
        return _densenet_path_map(params)
    out: dict[tuple[str, ...], str] = {}
    _resnet_trunk(out, params)
    _dense(out, "fc")
    return out


class _Kernel:
    """A skeleton leaf with only a shape (``_efficientnet_path_map`` reads
    the last conv's output width)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _skeleton(sd: dict) -> dict:
    """The key structure of the JAX ``params`` tree that maps onto the
    port state dict ``sd`` (keys and, where the path map reads one, a
    kernel's shape): what :func:`jax_path_map` walks."""
    keys = list(sd)

    def blocks(pattern):
        found = {}
        for k in keys:
            m = re.match(pattern, k)
            if m:
                found.setdefault(tuple(int(g) for g in m.groups()), set()).add(k)
        return dict(sorted(found.items()))

    if "pos_embed" in sd:
        tree = {"pos_embed": 0, **({"tok_embed": {}} if EMBEDDING in sd else {})}
        for (i,), ks in blocks(r"blocks\.(\d+)\.").items():
            tree[f"Block_{i}"] = {"MoeMlp_0": {}} if f"blocks.{i}.mlp.w_in" in ks else {}
        return tree
    if any(k.startswith("s1.b1.") for k in keys):  # RegNet
        tree, n = {"ConvBN_0": {}}, 0
        for (s, b), ks in blocks(r"s(\d+)\.b(\d+)\.").items():
            down = any(".downsample." in k for k in ks)
            blk = {f"ConvBN_{c}": {} for c in range(3 + down)}
            if any(".se." in k for k in ks):
                blk["SqueezeExcite_0"] = {}
            tree[f"RegNetBlock_{n}"], n = blk, n + 1
        return tree
    if any(k.startswith("features.denseblock") for k in keys):
        tree = {}
        for (i, j), _ in blocks(r"features\.denseblock(\d+)\.denselayer(\d+)\.").items():
            tree[f"block{i - 1}_layer{j - 1}"] = {}
        return tree
    if "conv_stem.weight" in sd:  # EfficientNet
        tree, n = {}, 0
        for (s, b), ks in blocks(r"blocks\.(\d+)\.(\d+)\.").items():
            last = f"blocks.{s}.{b}.conv_pwl.weight"
            if last not in sd:
                last = f"blocks.{s}.{b}.conv_pw.weight"
            convs = 3 if f"blocks.{s}.{b}.conv_pwl.weight" in sd else 2
            blk = {f"Conv_{c}": {} for c in range(convs)}
            blk[f"Conv_{convs - 1}"] = {"kernel": _Kernel((1, 1, 1, sd[last].shape[0]))}
            tree[f"MBConv_{n}"], n = blk, n + 1
        return tree
    # the ResNet family and BoTNet's trunk
    kind = "Bottleneck" if "layer1.0.conv3.weight" in sd else "BasicBlock"
    main = _BLOCK_CONVS[kind]
    tree, n, bot = {"ConvBN_0": {}}, 0, 0
    for (s, b), ks in blocks(r"layer(\d+)\.(\d+)\.").items():
        down = any(".downsample." in k for k in ks)
        if any(".mhsa." in k for k in ks):
            blk = {f"ConvBN_{c}": {} for c in range(2 + down)}
            blk["MHSA2D_0"] = {t: 0 for t in ("rel_height", "rel_width", "emb_height",
                                               "emb_width") if f"layer{s}.{b}.mhsa.{t}" in sd}
            tree[f"BoTBlock_{bot}"], bot = blk, bot + 1
            continue
        tree[f"{kind}_{n}"], n = {f"ConvBN_{c}": {} for c in range(main + down)}, n + 1
    return tree


def port_path_map(sd: dict) -> dict[str, tuple[str, ...]]:
    """``{port state-dict key: flax path}``, the inverse of
    :func:`jax_path_map` for the model whose state dict is ``sd`` (every
    arch the map knows; BN counters, which JAX does not keep, have none).
    The path's first entry is the tree, ``params`` or ``batch_stats``."""
    inv = {}
    for path, key in jax_path_map(_skeleton(sd)).items():
        tree = "batch_stats" if path[-1] in ("mean", "var") and "BatchNorm_0" in path \
            else "params"
        inv[key] = (tree, *path)
    missing = [k for k in sd if k not in inv and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"port keys with no JAX path: {missing[:5]}")
    return inv


def jax_tree_from_state_dict(sd: dict) -> dict:
    """The JAX package's ``{"params", "batch_stats"}`` trees (numpy, JAX
    layouts) for the port state dict ``sd``: the inverse of
    :func:`state_dict_from_jax` (BN counters dropped)."""
    out: dict = {}
    for key, path in port_path_map(sd).items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jax_layout(sd[key], key)
    return out


def jax_perm(key: str, ndim: int) -> tuple:
    """``perm`` with JAX dim j = port dim ``perm[j]`` for the port leaf
    ``key`` (:func:`_port_layout`'s transposes): a conv ``[O, I, kh, kw]``
    is JAX's ``[kh, kw, I, O]``, a Dense weight ``[out, in]`` JAX's ``[in,
    out]``; tables, MoE tensors and vectors as they are."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2 and not key.endswith(TABLES):
        return (1, 0)
    return tuple(range(ndim))


def jax_layout(t, key: str) -> np.ndarray:
    """A port tensor in its JAX leaf's layout (inverse of ``_port_layout``)."""
    a = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    return np.ascontiguousarray(a.transpose(jax_perm(key, a.ndim)))


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
    elif a.ndim == 2 and not key.endswith(TABLES):  # dense [I, O] -> [O, I]
        a = a.T
    return np.ascontiguousarray(a)


def state_dict_from_jax(params: dict, batch_stats: dict | None = None,
                        keep_dtype: bool = False) -> dict[str, torch.Tensor]:
    """The port's state dict for a JAX model's variables (numpy leaves; a
    ViT's or GPT's ``batch_stats`` is empty or None), in f32 (each leaf's
    own dtype with ``keep_dtype``). Every leaf lands in exactly one
    tensor; an unmapped leaf raises."""
    paths = jax_path_map(params)
    sd: dict[str, torch.Tensor] = {}
    for path, arr in [*_leaves(params), *_leaves(batch_stats or {})]:
        if path not in paths:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no port tensor")
        dtype = np.asarray(arr).dtype if keep_dtype else np.float32
        sd[paths[path]] = torch.from_numpy(_port_layout(arr, dtype, key=paths[path]))
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
    model's ``params`` (every tree ``jax_path_map`` knows):
    ``{"count", "m", "v"}`` with ``m`` the SGD trace or
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
                                       else np.float32, paths[p]) for p, a in _leaves(t)}

    adam = _find(opt_state, "mu")
    if adam is not None:
        return {"count": int(np.asarray(adam.count)), "m": tree(adam.mu), "v": tree(adam.nu)}
    trace = _find(opt_state, "trace")
    return {"count": int(np.asarray(opt_state.count)),
            "m": tree(trace.trace) if trace is not None else None, "v": None}


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a torch ``.pth``/``.pth.tar`` or an orbax checkpoint directory
    into ``model`` (strict: a JAX leaf with no port tensor, or a port
    tensor no leaf fills, raises; values are cast to the model's dtypes;
    a model placed on a model or expert axis takes its shards of them)."""
    if os.path.isdir(path):
        from distribuuuu_tpu_torch.utils import orbax

        tree = orbax.read_checkpoint(path, keys=orbax.WEIGHT_KEYS)
        if "params" not in tree:
            raise orbax.OrbaxFormatError(f"{path}: the checkpoint holds no 'params'")
        specs.load_full_model(model, state_dict_from_jax(tree["params"],
                                                         tree.get("batch_stats")))
        return model
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj.get("model", obj)) if isinstance(obj, dict) else obj
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    specs.load_full_model(model, densenet_legacy_keys(sd))
    return model


# torchvision's legacy DenseNet names: ``denselayerN.norm.1.weight`` for
# ``denselayerN.norm1.weight`` (its own ``_load_state_dict`` remap)
_DENSE_LEGACY = re.compile(
    r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|running_mean|"
    r"running_var|num_batches_tracked))$")


def densenet_legacy_keys(sd: dict) -> dict:
    """``sd`` with torchvision's legacy DenseNet keys (``norm.1.``,
    ``relu.1.``, ``conv.1.``) renamed as torchvision renames them; other
    keys as they are."""
    out = {}
    for k, v in sd.items():
        m = _DENSE_LEGACY.match(k)
        out[m.group(1) + m.group(2) if m else k] = v
    return out


def pretrained_refusal(arch: str) -> NotImplementedError:
    """MODEL.PRETRAINED fetches from the URL zoo, which needs the network."""
    return NotImplementedError(
        f"MODEL.PRETRAINED for {arch!r} downloads weights from the URL zoo and "
        "the port does not fetch from the network; download the .pth yourself "
        "and pass it as MODEL.WEIGHTS"
    )
