"""Shared helpers of the tests/test_torch_*.py files: one set of weights,
made from a seed with numpy, in the JAX model's variable tree (paths from
``model.init`` under ``jax.eval_shape``), the port's model on the same
weights through ``state_dict_from_jax``, and one f32 train step on both
sides."""

from __future__ import annotations

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from distribuuuu_tpu import models as jmodels
from distribuuuu_tpu_torch import config as tconfig
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax


def jax_model(model, im: int = 32):
    """(flax ``model``, its variable tree of ShapeDtypeStructs) at an
    ``im``² input."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, im, im, 3), jnp.float32), train=False),
        jax.random.key(0),
    )
    return model, nn.unbox(shapes)


def jax_resnet(arch: str, num_classes: int = 10, im: int = 32):
    """(flax model in f32, its variable tree of ShapeDtypeStructs)."""
    return jax_model(jmodels.build_model(arch, num_classes=num_classes, dtype=jnp.float32), im)


# a toy RegNet: widths [16, 24, 32, 56], depths [1, 2, 2, 1], group width 8
# (G = 2, 3, 4, 7); at 32² input stages 2 and 3 run at 4² and 2², so it
# has two stride-1 grouped 3x3 sites (blocks b2), both ≤ 14²
TOY_REGNET = dict(w_a=6.0, w_0=16, w_m=1.5, depth=6, group_w=8)


def jax_regnet(se_ratio: float = 0.25, num_classes: int = 10, im: int = 32, **kw):
    """(flax toy RegNet in f32, its variable tree of ShapeDtypeStructs);
    ``se_ratio`` 0 is an X model, 0.25 a Y model; ``kw`` go to the
    constructor (``bn_group``)."""
    from distribuuuu_tpu.models.regnet import RegNet

    return jax_model(RegNet(**TOY_REGNET, se_ratio=se_ratio, num_classes=num_classes,
                            dtype=jnp.float32, **kw), im)


def load_jax(model, variables: dict):
    """``model`` (the port's) holding ``variables``, in eval mode."""
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return model.eval()


def train_steps_side_by_side(jmodel, variables: dict, model, batch: dict, lr: float = 0.05):
    """One f32 train step of the JAX package (``make_train_step``, SGD
    Nesterov of ``construct_optimizer``) and of the port (``train_step``)
    from ``variables`` on ``batch`` (numpy). Returns (JAX loss, JAX
    state, port loss, port model, port optimizer)."""
    from distribuuuu_tpu import trainer as jtrainer
    from distribuuuu_tpu.config import cfg as jcfg
    from distribuuuu_tpu.parallel.partition.lowering import TrainState
    from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.config import cfg as tcfg
    from distribuuuu_tpu_torch.utils.optim import construct_optimizer

    jcfg.defrost()
    jcfg.OPTIM.BASE_LR = tcfg.OPTIM.BASE_LR = lr
    opt = jax_construct_optimizer()
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=opt.init(variables["params"]), step=jnp.int32(0),
                       key=jax.random.key(0))
    state, m = jtrainer.make_train_step(jmodel, opt, topk=5)(state, batch)
    model = load_jax(model, variables).train()
    topt = construct_optimizer(model)
    loss = trainer.train_step(model, topt, {"image": torch.from_numpy(batch["image"]),
                                            "label": torch.from_numpy(batch["label"])}, 5)["loss"]
    return float(m["loss"]), state, float(loss), model, topt


def port_regnet(jmodel, variables: dict, dtype=torch.float32, **kw):
    """The port's eval RegNet of ``jmodel``'s widths holding ``variables``.
    ``random_variables`` gives every BN scale, the zero-initialised last
    BN of each block included, a seeded non-zero value (about 0.4), so
    the residual branch, the grouped conv and the SE reach the logits."""
    from distribuuuu_tpu_torch.models.regnet import _regnet

    return load_jax(_regnet(jmodel.num_classes, **TOY_REGNET, se_ratio=jmodel.se_ratio,
                            dtype=dtype, **kw), variables)


def jax_vit(arch: str = "vit_small", num_classes: int = 10, im: int = 64, **kw):
    """(flax ViT in f32, its variable tree of ShapeDtypeStructs); ``kw``
    go to the constructor (``depth``, ``attn_impl``)."""
    return jax_model(jmodels.build_model(arch, num_classes=num_classes, dtype=jnp.float32,
                                         **kw), im)


def jax_gpt(seq_len: int = 32, vocab: int = 320, dim: int = 32, depth: int = 2,
            heads: int = 2, **kw):
    """(flax GPT in f32, its variable tree of ShapeDtypeStructs); ``kw``
    go to the constructor (``attn_impl``)."""
    from distribuuuu_tpu.models.gpt import GPT

    model = GPT(vocab_size=vocab, seq_len=seq_len, dim=dim, depth=depth,
                num_heads=heads, dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(
        lambda k: model.init(k, model.dummy_input(), train=False), jax.random.key(0)
    )
    return model, nn.unbox(shapes)


def port_gpt(jmodel, variables: dict, dtype=torch.float32, attn_impl: str = "xla"):
    """The port's eval GPT of ``jmodel``'s widths holding ``variables``."""
    from distribuuuu_tpu_torch.models.gpt import GPT

    model = GPT(vocab_size=jmodel.vocab_size, seq_len=jmodel.seq_len, dim=jmodel.dim,
                depth=jmodel.depth, num_heads=jmodel.num_heads, dtype=dtype,
                attn_impl=attn_impl)
    model.load_state_dict(state_dict_from_jax(variables["params"]))
    return model.eval()


def random_variables(shapes, seed: int = 0) -> dict:
    """Numpy leaves for every leaf of the tree: fan-in-scaled convs and
    dense, and BN scale/bias/mean/var away from their init (1, 0, 0, 1) so
    the eval fold is exercised. BN scales near 0.4 keep the residual sums,
    and so the logits, O(1), where an absolute tolerance means something.
    LayerNorm scales near 1 and biases near 0, ``pos_embed`` at 0.1 and a
    token ``embedding`` at 0.5; a MoE layer's router and experts
    fan-in-scaled, its biases at 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(parent, name, s):
        shape = tuple(s.shape)
        if name == "pos_embed":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "embedding":
            v = 0.5 * rng.standard_normal(shape)
        elif parent.startswith("LayerNorm") and name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("rel_height", "rel_width"):  # BoTNet's position tables
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif name == "kernel" and len(shape) == 4:
            std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
            v = rng.standard_normal(shape) * std
        elif name == "kernel" or name == "gate":  # a MoE router is [d, E]
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name in ("w_in", "w_out"):  # MoE experts [E, in, out]
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif name in ("b_in", "b_out"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "scale":
            v = 0.4 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            raise AssertionError(f"unexpected leaf {name}")
        return v.astype(np.float32)

    def walk(node, parent=""):
        return {k: walk(v, k) if isinstance(v, dict) else leaf(parent, k, v)
                for k, v in node.items()}

    return walk(shapes)


def port_model(arch: str, variables: dict, num_classes: int = 10,
               dtype=torch.float32):
    """The port's eval model holding ``variables``."""
    return load_jax(tmodels.build_model(arch, num_classes=num_classes, dtype=dtype), variables)


def reset_port_cfg():
    tconfig.reset_cfg()


def few_threads(n: int = 2):
    """A fixture body: PyTorch's CPU ops on ``n`` threads for the test.
    The suite runs several test processes at once; each spinning up a
    thread per core would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def stream_batch(step: int, n: int = 8):
    """tests/test_trajectory_x64.py's batches: learnable labels."""
    rng = np.random.default_rng(10_000 + step)
    images = rng.standard_normal((n, 32, 32, 3))
    labels = ((images.mean(axis=(1, 2, 3)) * 40.0).astype(np.int64) % 10).astype(np.int32)
    images += labels[:, None, None, None] * 0.1
    return {"image": images, "label": labels, "mask": np.ones((n,), np.float64)}


def jax_trace(opt_state):
    """The SGD momentum trace (a params-shaped tree) inside an optax state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    children = (opt_state.values() if isinstance(opt_state, dict)
                else opt_state if isinstance(opt_state, (tuple, list)) else ())
    if hasattr(opt_state, "inner_state"):
        children = [opt_state.inner_state]
    for child in children:
        found = jax_trace(child)
        if found is not None:
            return found
    return None


def compare_with_jax(trees, sd: dict, tol: float) -> int:
    """Every leaf of the JAX ``trees`` (each a params- or batch_stats-shaped
    tree, in order) against the port's ``sd`` (the keys ``jax_path_map``
    gives the first tree), within ``tol`` of the leaf's largest magnitude.
    Returns the number of leaves compared."""
    from distribuuuu_tpu_torch.utils.weights import TABLES, jax_path_map

    paths = jax_path_map(trees[0])
    n = 0
    for tree in trees:
        for path, key in paths.items():
            node = tree
            for p in path:
                node = node.get(p) if isinstance(node, dict) else None
                if node is None:
                    break
            if node is None:
                continue
            a = np.asarray(node)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2 and not key.endswith(TABLES):
                a = a.T
            np.testing.assert_allclose(sd[key].numpy(), a, rtol=tol,
                                       atol=tol * np.abs(a).max(), err_msg=key)
            n += 1
    return n


def make_tree(root: str, n_val: int = 5) -> str:
    """``root/{train,val}/c{0,1}/*.jpg``: 8 train JPEGs a class and
    ``n_val`` val JPEGs, seeded, colours separable by class."""
    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", n_val)):
        for i in range(n):
            c = i % 2
            d = os.path.join(root, split, f"c{c}")
            os.makedirs(d, exist_ok=True)
            w, h = (int(v) for v in rng.integers(36, 60, 2))
            arr = rng.integers(0, 128, (h, w, 3)) + np.asarray([120 * c, 60, 120 * (1 - c)])
            Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{i:03d}.jpg"), "JPEG", quality=90)
    return root


TP_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")


class Ranks:
    """``world`` ranks of ``tests/torch_tp_worker.py`` on one spec, started
    at once (gloo on the CPU, one thread each); :meth:`join` waits (killing
    all past ``timeout``), asserts every rank exited 0 and returns their
    outputs, rank order. The caller computes its references meanwhile."""

    def __init__(self, world: int, scenarios: list, tmp, tag: str, timeout: float = 150):
        import json
        import socket
        import subprocess
        import sys

        self.out, self.world, self.timeout = os.path.join(str(tmp), tag), world, timeout
        os.makedirs(self.out, exist_ok=True)
        spec = os.path.join(self.out, "spec.json")
        with open(spec, "w") as f:
            json.dump({"out": self.out, "scenarios": scenarios}, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.procs = []
        for r in range(world):
            log = open(os.path.join(self.out, f"rank{r}.log"), "w+")
            self.procs.append((subprocess.Popen(
                [sys.executable, TP_WORKER, spec], cwd=repo, stdout=log,
                stderr=subprocess.STDOUT,
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}), log))

    def join(self) -> list[dict]:
        texts = []
        try:
            for p, _ in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            for p, log in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.seek(0)
                texts.append((p.returncode, log.read()))
                log.close()
        for rc, text in texts:
            assert rc == 0, text[-4000:]
        return [torch.load(os.path.join(self.out, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def assemble(shards: dict, table, sizes: dict) -> dict:
    """The full state dict from every rank's ``shard_state_dict`` (``{rank:
    sd}`` over the row-major mesh of axis ``sizes``): its inverse, with no
    process group."""
    from distribuuuu_tpu_torch.parallel import mesh
    from distribuuuu_tpu_torch.parallel.partition import specs

    out = {}
    for key, t in shards[0].items():
        split = specs.split_of(table, key, sizes)
        if split is None:
            out[key] = t
            continue
        axis, dim = split
        parts = {mesh.coords_of(r, sizes)[axis]: sd[key] for r, sd in shards.items()}
        out[key] = torch.cat([parts[i] for i in range(sizes[axis])], dim)
    return out
