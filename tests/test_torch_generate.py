"""LM generation in the port (distribuuuu_tpu_torch/lm/) against the JAX
package's: the decoder's prefill and T=1 decode step (logits and the
written cache) on the same numpy-seeded weights, the engine's greedy and
seeded sampled streams, continuous batching against the isolated greedy
reference, tile growth, the config refusals, and the streaming socket
protocol. All in f32 on the CPU, where the decode step takes the
decode-attention kernel's plain version."""

from __future__ import annotations

import json
import socket
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, jax_gpt, port_gpt, random_variables, reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.config import cfg as jcfg
from distribuuuu_tpu.lm import generate as jgen
from distribuuuu_tpu_torch import serve_net
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.lm import generate as tgen
from distribuuuu_tpu_torch.lm import service as lm_service
from distribuuuu_tpu_torch.ops.cuda import decode_attn
from distribuuuu_tpu_torch.serve import protocol

# f32 sums in other orders than XLA's (dim 32, depth 2)
TOL = 1e-5
CPU = torch.device("cpu")
ENGINE = dict(prompt_len=8, max_new_tokens=8, batch_tiles=[1, 2], cache_tiles=[16, 32],
              eos_id=-1)
PROMPTS = [[5, 9, 2], [7, 1, 3, 4, 8, 2, 6, 0], [11, 12, 13, 14, 15], [200]]
SAMPLE = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield from few_threads()
    reset_port_cfg()


@pytest.fixture(scope="module")
def gpt():
    """(JAX GPT, numpy variables) at dim 32, depth 2, 2 heads, 32 positions."""
    jmodel, shapes = jax_gpt(seq_len=32)
    return jmodel, random_variables(shapes, seed=5)


@pytest.fixture(scope="module")
def jax_streams(gpt):
    """The JAX engine's greedy streams of PROMPTS and one sampled stream."""
    jmodel, variables = gpt
    eng = jgen.GenerateEngine(jmodel, variables, **ENGINE).start()
    try:
        greedy = [s.result(timeout=120) for s in [eng.submit(p) for p in PROMPTS]]
        sampled = eng.submit(PROMPTS[1], sample=SAMPLE).result(timeout=120)
    finally:
        eng.drain()
    return greedy, sampled


def _engine(gpt, **kw):
    return tgen.GenerateEngine(port_gpt(*gpt), device=CPU, **{**ENGINE, **kw})


def _cache(depth, b, h, c, d, seed=None):
    shape = (depth, b, h, c, d)
    if seed is None:
        return {k: np.zeros(shape, np.float32) for k in ("k", "v")}
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


def _port_cache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def _run_both(gpt, tokens, lengths, cache):
    jmodel, variables = gpt
    want, jcache = jgen.decoder_for(jmodel).apply(
        variables, jnp.asarray(tokens), jnp.asarray(lengths),
        {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = _port_cache(cache)
    with torch.inference_mode():
        got = tgen.decoder_for(port_gpt(*gpt))(
            torch.from_numpy(tokens), torch.from_numpy(lengths), tcache)
    return (got.numpy(), np.asarray(want), {k: t.numpy() for k, t in tcache.items()},
            {k: np.asarray(v) for k, v in jcache.items()})


def test_decoder_prefill_matches_jax(gpt):
    """A padded prompt tile against an empty page: logits at every
    position and the page the prefill writes."""
    jmodel = gpt[0]
    tokens = np.random.default_rng(1).integers(0, 320, (2, 8)).astype(np.int32)
    cache = _cache(jmodel.depth, 2, jmodel.num_heads, 8, jmodel.dim // jmodel.num_heads)
    got, want, tcache, jcache = _run_both(gpt, tokens, np.zeros(2, np.int32), cache)
    assert got.shape == (2, 8, 320)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k], jcache[k], rtol=0, atol=TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_step_matches_jax(gpt, impl):
    """A T=1 step over a random 64-wide cache at lengths [4, 40]: the port
    (the kernel's plain version on the CPU) against JAX's dense step and
    its Pallas kernel in interpret mode; logits and every cache position,
    the two written ones included."""
    jmodel = gpt[0]
    jcfg.KERNELS.DECODE_ATTN = impl
    h, d = jmodel.num_heads, jmodel.dim // jmodel.num_heads
    assert decode_attn.supported(1, 64, d, int(tcfg.KERNELS.DECODE_BLOCK))[0]
    cache = _cache(jmodel.depth, 2, h, 64, d, seed=2)
    lengths = np.asarray([4, 40], np.int32)
    decode_attn.reset_launch_counts()
    got, want, tcache, jcache = _run_both(gpt, np.asarray([[17], [250]], np.int32), lengths,
                                          cache)
    assert decode_attn.launches == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k], jcache[k], rtol=0, atol=TOL)
        for b, n in enumerate(lengths):  # the new token's K/V, at its row's length only
            assert not np.array_equal(tcache[k][:, b, :, n], cache[k][:, b, :, n])
            rest = np.arange(64) != n
            np.testing.assert_array_equal(tcache[k][:, b, :, rest], cache[k][:, b, :, rest])


def test_greedy_streams_match_jax(gpt, jax_streams):
    eng = _engine(gpt).start()
    try:
        got = [s.result(timeout=120) for s in [eng.submit(p) for p in PROMPTS]]
    finally:
        eng.drain()
    assert got == jax_streams[0]
    assert all(len(s) == 8 for s in got)


def test_sampled_stream_replays_and_matches_jax(gpt, jax_streams):
    eng = _engine(gpt).start()
    try:
        a = eng.submit(PROMPTS[1], sample=SAMPLE).result(timeout=120)
        b = eng.submit(PROMPTS[1], sample=SAMPLE).result(timeout=120)
        greedy = eng.submit(PROMPTS[1]).result(timeout=120)
    finally:
        eng.drain()
    assert a == b == jax_streams[1]
    assert a != greedy


def test_continuous_batching_ragged_requests_match_isolated_reference(gpt):
    """Seven concurrent requests of ragged prompts and budgets each give
    exactly the tokens the teacher-forced model gives alone (no request
    sees another's page), and every one retires."""
    model = port_gpt(*gpt)
    eng = tgen.GenerateEngine(model, device=CPU, prompt_len=8, max_new_tokens=8,
                              batch_tiles=[1, 2, 4], cache_tiles=[16, 32], eos_id=-1).start()
    rng = np.random.default_rng(4)
    subs = []
    for i in range(7):
        p = rng.integers(0, 256, (2 + i % 5,)).astype(np.int32)
        subs.append((p, 2 + i % 6, eng.submit(p, max_new_tokens=2 + i % 6)))
    try:
        for p, budget, stream in subs:
            got = stream.result(timeout=120)
            assert stream.reason == "max_new_tokens" and len(got) == budget
            seq = list(p)
            for tok in got:
                with torch.inference_mode():
                    lg = model(torch.tensor([seq]))
                assert tok == int(lg[0, -1].argmax())
                seq.append(tok)
        st = eng.stats()
    finally:
        eng.drain()
    assert st["requests"] == 7 and st["retired"] == 7
    assert st["queue_depth"] == 0 and st["active"] == 0


def test_tiles_grow_and_stats_keep_the_contract(gpt):
    eng = _engine(gpt, max_new_tokens=12)
    st = eng.stats()
    assert st["buckets"] == [[1, 16], [1, 32], [2, 16], [2, 32]]
    assert st["n_compiles"] == eng.n_compiles == 4 + 4  # decode tiles + prompt tiles 1..8
    eng.start()
    rng = np.random.default_rng(5)
    streams = [eng.submit(rng.integers(0, 256, (8,)), max_new_tokens=12) for _ in range(2)]
    try:
        for s in streams:  # 8 prompt + 12 new = 20 cached positions: past the 16 tile
            assert len(s.result(timeout=120)) == 12
    finally:
        eng.drain()
    assert (eng._b_tile, eng._c_tile) == (2, 32)
    st = eng.stats()
    assert set(st) >= {"queue_depth", "active", "slots", "n_compiles", "buckets",
                       "max_batch", "batch_occupancy", "decode_p50_ms", "decode_p99_ms",
                       "prefill_p50_ms", "prefill_p99_ms", "tokens_per_s", "decode_steps",
                       "new_tokens", "prompt_tokens", "requests", "retired"}
    assert st["new_tokens"] == 24 and st["prompt_tokens"] == 16


@pytest.mark.parametrize("fn,args", [
    ("validate_generate_cfg", (64, 16, 16, [2], [24])),
    ("validate_generate_cfg", (32, 8, 8, [2], [64])),
    ("validate_generate_cfg", (32, 0, 8, [2], [32])),
    ("validate_generate_cfg", (32, 8, 8, [0, 2], [32])),
    ("validate_chunk_prefill_cfg", (0, [32])),
    ("validate_chunk_prefill_cfg", (64, [32])),
    ("validate_chunk_prefill_cfg", (12, [16, 32])),
    ("validate_sample_cfg", (-0.5, 0, 1.0)),
    ("validate_sample_cfg", (0.5, -1, 1.0)),
    ("validate_sample_cfg", (0.5, 0, 1.5)),
])
def test_config_refusals_match_jax_letter_for_letter(fn, args):
    with pytest.raises(ValueError) as want:
        getattr(jgen, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(tgen, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sp", [dict(), dict(temperature=0.8, top_k=40, top_p=0.95, seed=7),
                                dict(temperature=1.3, top_k=3), dict(temperature=0.5, top_p=0.5)])
def test_token_selection_matches_jax(sp):
    """warp_probs, the counter-based uniforms and the inverse-CDF pick give
    JAX's token for every draw (float64 host numpy in both)."""
    rows = np.random.default_rng(9).standard_normal((6, 320)).astype(np.float32) * 3
    tsp, jsp = tgen.sample_params(sp), jgen.sample_params(sp)
    for n, row in enumerate(rows):
        u = tgen._uniform(tsp.seed, 0, n)
        assert u == jgen._uniform(jsp.seed, 0, n)
        assert tgen.sample_token(row, tsp, u) == jgen.sample_token(row, jsp, u)
        if not tsp.greedy:
            np.testing.assert_array_equal(tgen.warp_probs(row, tsp), jgen.warp_probs(row, jsp))


def test_tile_defaults_match_jax():
    assert tgen.validate_generate_cfg(64, 16, 16, [], []) == ([1, 2, 4], [64])
    for cap in (1, 5, 8, 64):
        assert tgen.default_tiles(cap) == jgen.default_tiles(cap)


# chunked prefill, the draft model and the length classes run since the
# LM plane was ported; each knob's case now holds one of its refusals
@pytest.mark.parametrize("kw,match", [
    ({"chunk_prefill": 12}, "does not divide GENERATE.CACHE_TILES entry 16"),
    ({"draft_model": SimpleNamespace(vocab_size=256, seq_len=32)},
     "draft/target vocab mismatch"),
    ({"long_prompt_threshold": 4, "long_max_queue": 4, "max_queue": 4},
     "must leave short-class headroom"),
    ({"long_max_queue": 2}, "without SERVE.LONG_PROMPT_THRESHOLD"),
], ids=["kw0", "kw1", "kw2", "kw3"])
def test_refused_engine_knobs(gpt, kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(gpt, **kw)


ENGINE_CFG_REFUSALS = [
    (["MESH.MODEL", 2], NotImplementedError, "Parallel layouts beyond DP"),
    (["GENERATE.SPECULATE.ENABLED", True, "GENERATE.SPECULATE.DRAFT_ARCH", "resnet18"],
     ValueError, "is not a gpt_"),
    (["GENERATE.CHUNK_PREFILL", 12], ValueError, "does not divide"),
    (["SERVE.LONG_MAX_QUEUE", 4], ValueError, "without SERVE.LONG_PROMPT_THRESHOLD"),
    # the MoE GPT decodes since it was ported; across an expert axis it does not
    (["MODEL.ARCH", "gpt_nano_moe", "MESH.EXPERT", 2], NotImplementedError,
     "Parallel layouts beyond DP"),
    (["KERNELS.DECODE_ATTN", "pallas"], ValueError, "accepts only"),
    (["KERNELS.DECODE_BLOCK", 12], ValueError, "multiple of 8"),
    (["MODEL.ARCH", "resnet18"], ValueError, "serves the gpt_"),
]


# the first four ids keep the names of the "LM plane" refusals these cases
# held before the LM plane was ported: TP decode moved to "Parallel layouts
# beyond DP", the other three knobs run now and their cases hold the knobs'
# own refusals
@pytest.mark.parametrize("opts,err,match", ENGINE_CFG_REFUSALS, ids=[
    *(f"opts{i}-NotImplementedError-LM plane" for i in range(4)),
    *(f"opts{i}-{e.__name__}-{m}" for i, (_, e, m) in enumerate(ENGINE_CFG_REFUSALS)
      if i >= 4)])
def test_engine_from_cfg_refusals(opts, err, match):
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "LM.SEQ_LEN", 32,
                          "GENERATE.PROMPT_LEN", 8, "GENERATE.MAX_NEW_TOKENS", 8, *opts])
    with pytest.raises(err, match=match):
        lm_service.engine_from_cfg()


def test_engine_from_cfg_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for machines without it")
    tconfig.merge_from_file("config/gpt_nano.yaml")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        lm_service.engine_from_cfg()
    with pytest.raises(SystemExit, match="generate ctrl frames"):
        serve_net.main(["--cfg", "config/gpt_nano.yaml", "--batch-input", "x.npy",
                        "DEVICE.PLATFORM", "cpu", "LM.SEQ_LEN", "32", "GENERATE.PROMPT_LEN",
                        "8", "GENERATE.MAX_NEW_TOKENS", "8"])


def test_generate_streams_over_the_socket():
    """engine_from_cfg on the CPU at gpt_nano's width (16 positions), one
    generate request over loopback: token frames, then done; the stats
    frame keeps the image replica's contract."""
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "RNG_SEED", 0, "LM.SEQ_LEN", 16, "GENERATE.PROMPT_LEN", 4,
                          "GENERATE.MAX_NEW_TOKENS", 4, "GENERATE.BATCH_TILES", [1, 2]])
    eng = lm_service.engine_from_cfg().start()
    listener = protocol.open_listener("127.0.0.1", 0)
    port = listener.getsockname()[1]
    stop = threading.Event()
    t = threading.Thread(target=protocol.serve_forever, args=(eng, listener, stop.is_set),
                         daemon=True)
    t.start()
    try:
        frames = list(lm_service.generate_request("127.0.0.1", port, text="hi!",
                                                  max_new_tokens=3))
        toks = [f["token"] for f in frames if f.get("stream") == "token"]
        done = frames[-1]
        assert done["stream"] == "done" and done["tokens"] == toks
        assert [f["i"] for f in frames[:-1]] == list(range(len(toks)))
        assert done["reason"] in ("eos", "max_new_tokens") and 1 <= len(toks) <= 3
        with socket.create_connection(("127.0.0.1", port)) as c:
            protocol.send_frame(c, protocol.ctrl_request("stats"))
            st = json.loads(protocol.recv_frame(c))
        assert st["n_compiles"] == st["aot_compiles"] >= len(st["buckets"]) == 2
        assert st["jit_compiles"] == 0 and st["accepting"] is True
        assert st["requests"] == 1 and st["retired"] == 1
        with pytest.raises(RuntimeError, match="PROMPT_LEN"):
            list(lm_service.generate_request("127.0.0.1", port, tokens=list(range(9))))
    finally:
        stop.set()
        t.join(timeout=30)
