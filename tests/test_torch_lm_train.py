"""GPT training in the port against the JAX package's: the per-token
metrics over ``[B, S, V]``, the eval step's token count and sums, three
AdamW train steps of a GPT of dim 32, depth 2, 2 heads and 32 positions
under the dense causal region and under the flash kernels' plain versions
(JAX's Pallas flash in interpret mode), and ``train_model`` on token
shards packed from a generated corpus: the loss falls, the eval counts
tokens, and a preempted epoch resumes at the exact next batch on the
uninterrupted run's state. f32 on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_token_shards import _docs
from torch_port_util import few_threads, jax_gpt, port_gpt, random_variables, reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu import trainer as jtrainer
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.parallel.partition.lowering import TrainState, make_eval_step
from distribuuuu_tpu.utils import metrics as jmetrics
from distribuuuu_tpu.utils.optim import construct_optimizer as jax_construct_optimizer
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.data.shards import tokens as ttok
from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa
from distribuuuu_tpu_torch.utils import checkpoint as ckpt
from distribuuuu_tpu_torch.utils import faults, preempt
from distribuuuu_tpu_torch.utils import metrics as tmetrics
from distribuuuu_tpu_torch.utils.optim import construct_optimizer
from distribuuuu_tpu_torch.utils.weights import jax_path_map

SEQ, BATCH, STEPS = 32, 4, 3
# three f32 AdamW steps: the parameters' L2 distance to JAX's within this
# share of their L2 norm (sums in other orders than XLA's; AdamW's update
# divides by sqrt(v), which magnifies the gradients' rounding on the first
# steps)
STEP_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    faults.reset()
    preempt.reset()
    yield from few_threads()
    reset_port_cfg()
    faults.reset()
    preempt.reset()


def _tokens(seed, b=BATCH, s=SEQ):
    seq = np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(np.int32)
    return {"image": seq[:, :-1], "label": seq[:, 1:], "mask": np.ones((b,), np.float32)}


def test_per_token_metrics_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    want_ce = float(jmetrics.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got_ce = float(tmetrics.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got_ce, want_ce, rtol=1e-6)
    flat = float(tmetrics.cross_entropy(torch.from_numpy(logits.reshape(-1, 11)),
                                        torch.from_numpy(labels.reshape(-1))))
    np.testing.assert_allclose(got_ce, flat, rtol=1e-6)  # one mean over every token
    want = jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk=(1, 5))
    got = tmetrics.accuracy(torch.from_numpy(logits), torch.from_numpy(labels), topk=(1, 5))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)


@pytest.fixture(scope="module")
def gpt():
    jmodel, shapes = jax_gpt(seq_len=SEQ)
    return jmodel, random_variables(shapes, seed=3)


def test_eval_step_counts_tokens_and_matches_jax(gpt):
    """The last sequence is padding (mask 0): count is mask · S, and the
    loss and hit sums are JAX's eval step's."""
    jmodel, variables = gpt
    batch = _tokens(2)
    batch["mask"][-1] = 0.0
    state = TrainState(params=variables["params"], batch_stats={}, opt_state=None,
                       step=jnp.int32(0), key=jax.random.key(0))
    want = make_eval_step(jmodel, topk=5)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = trainer.eval_step(port_gpt(*gpt), {k: torch.from_numpy(v) for k, v in batch.items()},
                            5)
    assert float(got["count"]) == float(want["count"]) == (BATCH - 1) * SEQ
    for k in ("correct1", "correctk"):
        assert float(got[k]) == float(want[k]), k
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-6)


def _l2(a: dict, b: dict) -> tuple[float, float]:
    d = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    return np.sqrt(d), np.sqrt(sum(float(np.sum(b[k] ** 2)) for k in b))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_adamw_steps_match_jax(gpt, impl, monkeypatch):
    """Three AdamW steps (gpt_nano.yaml's optimizer) through the port's
    ``TrainStep`` and JAX's ``make_train_step``: the losses within 1e-5,
    the parameters' L2 distance within ``STEP_TOL`` of their L2 norm;
    under ``flash`` the causal flash forward ran once a block a step (its
    plain version on the CPU), under ``xla`` never."""
    jmodel, shapes = jax_gpt(seq_len=SEQ, attn_impl=impl)
    variables = random_variables(shapes, seed=3)
    calls = []
    plain = fa.forward_plain
    monkeypatch.setattr(fa, "forward_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    saved = jcfg.clone()
    try:
        jcfg.merge_from_file("config/gpt_nano.yaml")
        tconfig.merge_from_file("config/gpt_nano.yaml")
        opt = jax_construct_optimizer()
        state = TrainState(params=variables["params"], batch_stats={},
                           opt_state=opt.init(variables["params"]), step=jnp.int32(0),
                           key=jax.random.key(0))
        step = jtrainer.make_train_step(jmodel, opt, topk=5)
        model = port_gpt(jmodel, variables, attn_impl=impl).train()
        topt = construct_optimizer(model)
        runner = trainer.TrainStep(model, topt, 5, device=torch.device("cpu"))
        jl, tl = [], []
        for i in range(STEPS):
            b = _tokens(10)  # one batch three times: the loss falls
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            jl.append(float(m["loss"]))
            out = runner([{k: torch.from_numpy(b[k]) for k in ("image", "label")}], [False])
            tl.append(float(out[0, 0]))
    finally:
        jcfg.merge_from_other_cfg(saved)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    want = {}
    for path, key in jax_path_map(state.params).items():
        node = state.params
        for p in path:
            node = node[p]
        a = np.asarray(node)
        want[key] = a.T if a.ndim == 2 and "embed" not in key else a
    assert set(want) == set(sd)
    # the key projection's bias has a true gradient of 0 (a constant added
    # to every key's score leaves the softmax as it is): its gradient is
    # rounding, which AdamW turns into steps of about lr either way, so it
    # is held apart, to 2 lr a step
    d = jmodel.dim
    for i in range(jmodel.depth):
        key = f"blocks.{i}.attn.qkv.bias"
        kb = np.abs(sd[key][d:2 * d] - want[key][d:2 * d])
        assert kb.max() <= 2 * tcfg.OPTIM.BASE_LR * STEPS, (key, kb.max())
        sd[key], want[key] = np.delete(sd[key], np.s_[d:2 * d]), np.delete(want[key],
                                                                           np.s_[d:2 * d])
    dist, norm = _l2(sd, want)
    assert dist <= STEP_TOL * norm, (dist, norm)
    assert topt.count == STEPS
    assert calls == ([True] * jmodel.depth * STEPS if impl == "flash" else [])


def test_gpt_fold_is_bitwise_the_per_step_run(gpt):
    """TRAIN.STEPS_PER_CALL 3 folds three GPT steps into one call of the
    step's graph body: the same parameters and AdamW moments, bit for bit,
    as three one-step calls."""
    tconfig.merge_from_file("config/gpt_nano.yaml")
    batches = [{k: torch.from_numpy(v) for k, v in _tokens(20 + i).items() if k != "mask"}
               for i in range(3)]
    states = []
    for fold in (3, 1):
        tcfg.TRAIN.STEPS_PER_CALL = fold
        model = port_gpt(*gpt).train()
        opt = construct_optimizer(model)
        step = trainer.TrainStep(model, opt, 5, fold=fold, device=torch.device("cpu"))
        for part in ([batches] if fold == 3 else [[b] for b in batches]):
            step(part, [False] * len(part))
        states.append((model.state_dict(), [m.clone() for m in opt.m],
                       [v.clone() for v in opt.v], opt.count))
    (sd3, m3, v3, n3), (sd1, m1, v1, n1) = states
    assert n3 == n1 == 3
    for k in sd1:
        assert torch.equal(sd3[k], sd1[k]), k
    for a, b in zip(m3 + v3, m1 + v1):
        assert torch.equal(a, b)


def _pack(root, n_docs=80):
    return ttok.write_token_shards(str(root / "train"), ttok.pack_token_stream(_docs(n_docs), SEQ),
                                   SEQ, target_bytes=2048)


def _lm_cfg(pack, out, *opts):
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "LM.SEQ_LEN", SEQ, "TRAIN.DATASET", str(pack), "TEST.DATASET",
                          str(pack), "TEST.SPLIT", "train", "TRAIN.BATCH_SIZE", 8,
                          "TEST.BATCH_SIZE", 48, "TRAIN.WORKERS", 1, "TRAIN.PRINT_FREQ", 4,
                          "OPTIM.MAX_EPOCH", 1, "RNG_SEED", 1, "DATA.SHARDS_BLOCK", 4,
                          "DATA.SHARDS_WINDOW", 16, "OUT_DIR", str(out), *opts])


def test_train_model_on_token_shards_resumes_exactly(tmp_path):
    """``train_model`` over a packed corpus (gpt_nano at 32 positions):
    the loss falls over the epoch, the epoch record has the token rate,
    the eval counts tokens; preempted after batch 3 and rerun, the epoch
    continues at batch 5 and ends on the uninterrupted run's weights and
    AdamW state."""
    _pack(tmp_path / "pack")
    _lm_cfg(tmp_path / "pack", tmp_path / "ref")
    records = []
    trainer.train_model(records)
    rec = records[0]
    n = len(rec["losses"])
    assert n >= 10 and np.mean(rec["losses"][-3:]) < np.mean(rec["losses"][:3])
    assert rec["tokens_per_s"] == pytest.approx(rec["seqs_per_s"] * SEQ)
    n_seq = len(ttok.TokenShardDataset(str(tmp_path / "pack"), "train", SEQ))
    assert rec["eval_images"] == n_seq * SEQ  # tokens, the padded tail masked out
    ref = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    # test_net on the saved weights: the epoch's eval again
    tcfg.MODEL.WEIGHTS = ckpt.get_checkpoint(0)
    top1, _ = trainer.test_model()
    assert top1 == pytest.approx(rec["acc1"], rel=1e-6)

    reset_port_cfg()
    _lm_cfg(tmp_path / "pack", tmp_path / "run", "FAULTS.ENABLED", True,
            "FAULTS.PREEMPT_EPOCH", 0, "FAULTS.PREEMPT_AT_BATCH", 3)
    trainer.train_model([])
    payload = ckpt.load_checkpoint(ckpt.get_preempt_checkpoint(0))
    ds = ckpt.decode_data_state(payload["data_state"])
    assert ds["cursor"] == 4 * 8 and ds["dataset_identity"]["kind"] == "tokens"
    reset_port_cfg()
    faults.reset()
    preempt.reset()
    _lm_cfg(tmp_path / "pack", tmp_path / "run")
    rest = []
    trainer.train_model(rest)
    assert rest[0]["start_batch"] == 4 and rest[0]["steps"] == n - 4
    np.testing.assert_array_equal(rest[0]["losses"], rec["losses"][4:])
    got = ckpt.load_checkpoint(ckpt.get_checkpoint(0))
    for k, v in ref["model"].items():
        assert torch.equal(got["model"][k], v), k
    m, want_m = got["opt"]["m"], ref["opt"]["m"]
    assert len(want_m) == len(ref["model"])
    for k in want_m:
        assert torch.equal(m[k], want_m[k]), k
