"""Write the orbax fixture of tests/data/orbax_toy/ with the JAX package.

    python tests/make_orbax_toy.py [--out tests/data/orbax_toy]

Saves, through the JAX package's own checkpoint code
(``distribuuuu_tpu/utils/checkpoint.py``):

* ``cnn_best/``: a narrow RegNetX (``torch_port_util.TOY_REGNET``, 10
  classes, BN moved off its init) by the weights-only best side-write;
* ``cnn_full/``: the same model's full ``save_checkpoint`` (params,
  batch_stats, the optimizer state of SGD without momentum, step, epoch,
  best_acc1);
* ``gpt_best/``: a GPT of tests/test_lm_speculative.py's widths (vocab 320,
  seq 32, dim 32, depth 1, 2 heads) by the same best side-write;
* ``cnn_images.npy`` and ``cnn_logits.npy``: seeded uint8 images and the
  JAX f32 eval forward's logits on them (as f32, ``x / 64 - 2``);
* ``gpt_prompts.npy`` and ``gpt_tokens.npy``: seeded prompts and the JAX
  f32 model's greedy continuations (a full forward per token);
* ``meta.json``: the widths, so a reader can build the same models.

Every weight is an f32 that a bf16 can hold (``_bf16_exact``), which keeps
the committed files under 512 KB.

The test of the reader (tests/test_torch_orbax.py) rebuilds this in a
temporary directory and holds the committed copy to it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # torch_port_util; the repo root
DEFAULT_OUT = os.path.join(HERE, "data", "orbax_toy")
GPT = dict(vocab_size=320, seq_len=32, dim=32, depth=1, num_heads=2)
IMAGES = 2
IM = 32
CLASSES = 10
PROMPTS = 2
PROMPT_LEN = 8
NEW_TOKENS = 8


def _save(save, out_dir: str, name: str) -> None:
    """Run ``save(ckpt module)`` with the JAX cfg's OUT_DIR in a temporary
    directory and move the directory it wrote to ``out_dir/name``."""
    from distribuuuu_tpu.config import cfg
    from distribuuuu_tpu.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        cfg.defrost()
        old, cfg.OUT_DIR = cfg.OUT_DIR, tmp
        try:
            path = save(ckpt)
            from distribuuuu_tpu.asyncplane import committer

            committer.join_commits()
            dest = os.path.join(out_dir, name)
            shutil.rmtree(dest, ignore_errors=True)
            shutil.copytree(path, dest)
        finally:
            cfg.OUT_DIR = old


def images_f32(images):
    """The f32 input the logits were computed on, from the uint8 file."""
    import numpy as np

    return images.astype(np.float32) / 64.0 - 2.0


def _bf16_exact(tree):
    """Every leaf rounded to the nearest f32 a bf16 can hold: the low 16
    bits of each f32 are zero, which zstd packs, so the committed fixture
    stays small. The values are f32 all the same."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _bf16_exact(v) for k, v in tree.items()}
    bits = np.asarray(tree, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(np.float32)


def make(out_dir: str = DEFAULT_OUT) -> dict:
    """Write the fixture into ``out_dir``; returns its meta."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from torch_port_util import TOY_REGNET, jax_gpt, jax_regnet, random_variables

    from distribuuuu_tpu.parallel.partition.lowering import TrainState
    from distribuuuu_tpu.utils.optim import construct_optimizer

    os.makedirs(out_dir, exist_ok=True)
    jmodel, shapes = jax_regnet(se_ratio=0.0, num_classes=CLASSES, im=IM)
    v = _bf16_exact(random_variables(shapes, seed=3))
    _save(lambda ck: ck._write_best(v["params"], v["batch_stats"], 0), out_dir, "cnn_best")
    from distribuuuu_tpu.config import cfg

    cfg.defrost()
    momentum, cfg.OPTIM.MOMENTUM = cfg.OPTIM.MOMENTUM, 0.0  # SGD with no trace: fewer files
    try:
        opt = construct_optimizer()
    finally:
        cfg.OPTIM.MOMENTUM = momentum
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=opt.init(v["params"]), step=jnp.int32(7),
                       key=jax.random.key(0))
    from distribuuuu_tpu import trainer

    def full(ck):
        ck.save_checkpoint(trainer._state_tree(state), 1, 12.5, False)
        return ck.get_checkpoint(1)

    _save(full, out_dir, "cnn_full")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (IMAGES, IM, IM, 3)).astype(np.uint8)
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, images_f32(images)), np.float32)
    np.save(os.path.join(out_dir, "cnn_images.npy"), images)
    np.save(os.path.join(out_dir, "cnn_logits.npy"), logits)

    gmodel, gshapes = jax_gpt(seq_len=GPT["seq_len"], vocab=GPT["vocab_size"], dim=GPT["dim"],
                              depth=GPT["depth"], heads=GPT["num_heads"])
    gv = _bf16_exact(random_variables(gshapes, seed=4))
    _save(lambda ck: ck._write_best(gv["params"], {}, 0), out_dir, "gpt_best")
    prompts = rng.integers(0, 256, (PROMPTS, PROMPT_LEN)).astype(np.int32)
    # greedy, a full causal forward per token over the sequence padded to
    # one length (one compile; the padding cannot reach earlier positions)
    fwd = jax.jit(lambda v, x: gmodel.apply(v, x, train=False))
    seqs = np.zeros((PROMPTS, PROMPT_LEN + NEW_TOKENS), np.int32)
    seqs[:, :PROMPT_LEN] = prompts
    for t in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS):
        seqs[:, t] = np.asarray(fwd(gv, jnp.asarray(seqs)))[:, t - 1].argmax(-1)
    np.save(os.path.join(out_dir, "gpt_prompts.npy"), prompts)
    np.save(os.path.join(out_dir, "gpt_tokens.npy"), seqs[:, PROMPT_LEN:])
    meta = {"regnet": dict(TOY_REGNET, se_ratio=jmodel.se_ratio, num_classes=CLASSES),
            "im": IM, "gpt": GPT, "new_tokens": NEW_TOKENS}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    make(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
