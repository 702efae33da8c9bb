"""The port's GPT (distribuuuu_tpu_torch/models/gpt.py) against the JAX
GPT on the same numpy-seeded weights, its weight mapping at gpt_nano's
full width, its construction from the config, and the byte tokenizer."""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (
    few_threads,
    jax_gpt,
    port_gpt,
    random_variables,
    reset_port_cfg,
)

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.lm.tokenizer import ByteTokenizer as JaxTokenizer
from distribuuuu_tpu.models.gpt import gpt_nano as jax_gpt_nano
from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.lm.tokenizer import ByteTokenizer
from distribuuuu_tpu_torch.utils.weights import state_dict_from_jax

# f32 sums in another order than XLA's at dim 32, depth 2
TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield from few_threads()
    reset_port_cfg()


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 320, (b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "flash", "blockwise"])
def test_logits_match_jax(impl):
    """Logits at every position equal the JAX GPT's (the JAX flash and
    blockwise paths run their blockwise scan off the TPU, the port's flash
    its kernels' plain versions: the same exact softmax)."""
    jmodel, shapes = jax_gpt(attn_impl=impl)
    variables = random_variables(shapes, seed=1)
    toks = _tokens(2, 32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks), train=False))
    model = port_gpt(jmodel, variables, attn_impl=impl)
    with torch.inference_mode():
        got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 320)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_attention_is_causal():
    """A perturbed tail leaves every earlier logit bit-equal."""
    jmodel, shapes = jax_gpt(seq_len=12)
    model = port_gpt(jmodel, random_variables(shapes, seed=2))
    a = _tokens(1, 12, seed=3)
    b = a.copy()
    b[0, 7:] = (b[0, 7:] + 11) % 256
    with torch.inference_mode():
        la, lb = model(torch.from_numpy(a)), model(torch.from_numpy(b))
    assert torch.equal(la[0, :7], lb[0, :7])
    assert not torch.allclose(la[0, 7:], lb[0, 7:])


def test_shorter_inputs_and_the_context_limit():
    jmodel, shapes = jax_gpt(seq_len=16)
    model = port_gpt(jmodel, random_variables(shapes))
    with torch.inference_mode():
        assert model(torch.zeros((1, 5), dtype=torch.long)).shape == (1, 5, 320)
        with pytest.raises(ValueError, match="exceeds the trained context LM.SEQ_LEN=16"):
            model(torch.zeros((1, 17), dtype=torch.long))


def test_gpt_nano_weights_map_at_full_width():
    """gpt_nano's JAX tree (908,352 parameters in 54 leaves) lands in the
    port's gpt_nano, every leaf in one tensor."""
    jmodel = jax_gpt_nano(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jmodel.dummy_input(), train=False), jax.random.key(0))
    params = nn.unbox(shapes)["params"]
    leaves = jax.tree_util.tree_leaves(params)
    sd = state_dict_from_jax(random_variables(params, seed=0))
    model = tmodels.build_model("gpt_nano", dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    n = sum(p.numel() for p in model.parameters())
    assert (len(leaves), len(sd), n) == (54, 54, 908_352)
    assert sum(int(np.prod(x.shape)) for x in leaves) == n
    assert sd["tok_embed.weight"].shape == (320, 128)
    assert sd["blocks.3.attn.qkv.weight"].shape == (384, 128)


def test_build_model_from_cfg_routes_attention():
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["LM.SEQ_LEN", 64])
    model = trainer.build_model_from_cfg()
    assert (model.seq_len, model.dim, model.depth, model.num_heads) == (64, 128, 4, 4)
    assert model.vocab_size == 320 and model.dtype == torch.bfloat16
    assert {b.attn.attn_impl for b in model.blocks} == {"xla"}  # auto = dense causal
    assert all(b.attn.causal for b in model.blocks)
    tcfg.DEVICE.ATTN_IMPL = "flash"
    assert trainer.build_model_from_cfg().blocks[0].attn.attn_impl == "flash"
    tcfg.DEVICE.ATTN_IMPL = "ring"
    with pytest.raises(ValueError, match="MESH.SEQ > 1"):
        trainer.build_model_from_cfg()
    tcfg.DEVICE.ATTN_IMPL = "auto"
    tcfg.MESH.SEQ = 2
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        trainer.build_model_from_cfg()
    tcfg.MESH.SEQ = 1
    tcfg.MODEL.ARCH = "gpt_nano_moe"  # ported: MoE FFNs in blocks 1 and 3
    assert [b.mlp.__class__.__name__ for b in trainer.build_model_from_cfg().blocks] == [
        "Mlp", "MoeMlp", "Mlp", "MoeMlp"]
    tcfg.MESH.EXPERT = 2  # one process: the stanza needs two
    with pytest.raises(ValueError, match="number of processes"):
        trainer.check_train_cfg()
    tcfg.MESH.EXPERT = 1
    tcfg.MODEL.ARCH = "gpt_nano"
    trainer.check_train_cfg()  # gpt_nano.yaml's DATA.FORMAT tokens
    tcfg.DATA.FORMAT = "imagefolder"
    with pytest.raises(ValueError, match="trains and evaluates on token shards"):
        trainer.check_train_cfg()  # the GPT trains on token shards, not images
    tcfg.DATA.FORMAT = "tokens"
    trainer.check_train_cfg()


def test_tokenizer_round_trips_and_matches_jax():
    tok = ByteTokenizer()
    text = "héllo, wörld"
    ids = tok.encode(text)
    assert ids.dtype == np.uint16 and tok.decode(ids) == text
    np.testing.assert_array_equal(ids, JaxTokenizer().encode(text))
    assert tok.decode([104, 105, 256, 300]) == "hi"
    assert tok.identity() == JaxTokenizer().identity()
