"""The LM serving plane of the port against the JAX package's: chunked
paged prefill (page logits against whole-prompt prefill, greedy streams
against JAX's chunked engine, prompts past PROMPT_LEN), the length classes
(admission decisions and messages, the queue-full frame), and speculative
decoding (the config refusals, greedy streams identical to target-only
decode and to JAX's speculative engine, a sampled stream identical to
JAX's at a fixed seed, the draft from the config). A GPT of dim 32, depth
2, 2 heads and 32 positions, numpy-seeded weights, f32 on the CPU, where
the T=1 steps take the decode-attention kernel's plain version."""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads, jax_gpt, port_gpt, random_variables, reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.lm import generate as jgen
from distribuuuu_tpu.lm import service as jservice
from distribuuuu_tpu.serve import admission as jadm
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.lm import generate as tgen
from distribuuuu_tpu_torch.lm import service as tservice
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.serve import admission as tadm

CPU = torch.device("cpu")
TOL = 1e-5  # f32 sums in other orders than XLA's (dim 32, depth 2)
SAMPLE = {"temperature": 1.1, "top_k": 0, "top_p": 0.9, "seed": 77}


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield from few_threads()
    reset_port_cfg()


@pytest.fixture(scope="module")
def target():
    jmodel, shapes = jax_gpt(seq_len=32)
    return jmodel, random_variables(shapes, seed=5)


@pytest.fixture(scope="module")
def draft():
    """A draft of the target's widths with its own weights: it disagrees."""
    jmodel, shapes = jax_gpt(seq_len=32)
    return jmodel, random_variables(shapes, seed=6)


def _port(gpt, draft=None, **kw):
    if draft is not None:
        kw["draft_model"] = port_gpt(*draft)
    return tgen.GenerateEngine(port_gpt(*gpt), device=CPU, **{"eos_id": -1, **kw})


def _jax(gpt, draft=None, **kw):
    if draft is not None:
        kw.update(draft_model=draft[0], draft_variables=draft[1])
    return jgen.GenerateEngine(gpt[0], gpt[1], **{"eos_id": -1, **kw})


def _streams(eng, prompts, **kw):
    eng.start()
    try:
        return [eng.submit(p, **kw).result(timeout=120) for p in prompts]
    finally:
        eng.drain()


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lengths]


# ------------------------------------------------------- chunked prefill


def test_chunk_page_logits_match_jax_whole_prompt_prefill(target):
    """A 6-token prompt streamed into a 32-wide page in chunks of 4 (the
    second one padded) gives, at every prompt position, the logits of
    JAX's whole-prompt prefill within 1e-5; the page's K/V too."""
    jmodel, variables = target
    eng = _port(target, prompt_len=8, max_new_tokens=6, batch_tiles=[2], cache_tiles=[32],
                chunk_prefill=4)
    prompt = _prompts(11, [6])[0]
    padded = np.zeros((1, 8), np.int32)
    padded[0, :6] = prompt
    h, d = jmodel.num_heads, jmodel.dim // jmodel.num_heads
    zero = {k: jnp.zeros((jmodel.depth, 1, h, 8, d), jnp.float32) for k in ("k", "v")}
    want, jpage = jgen.decoder_for(jmodel).apply(variables, jnp.asarray(padded),
                                                 jnp.zeros((1,), jnp.int32), zero)
    g = eng._page_graph(32)
    rows = []
    with torch.inference_mode():
        for k in g.inputs["k"], g.inputs["v"]:
            k.zero_()
        for i in range(2):
            chunk = np.zeros((1, 4), np.int32)
            seg = prompt[i * 4:(i + 1) * 4]
            chunk[0, :len(seg)] = seg
            rows.append(g(tokens=torch.from_numpy(chunk),
                          lengths=torch.tensor([i * 4], dtype=torch.int32))[0].clone())
    got = torch.cat(rows)[:6].numpy()
    np.testing.assert_allclose(got, np.asarray(want)[0, :6], rtol=0, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(g.inputs[k][:, :, :, :6].numpy(),
                                   np.asarray(jpage[k])[:, :, :, :6], rtol=0, atol=TOL)
    eng.drain()


def test_chunked_greedy_streams_match_jax_chunked_engine(target):
    """Ragged prompts (shorter than a chunk, whole chunks, ragged, and 20
    tokens, past PROMPT_LEN=8) through the port's chunked engine: the
    same greedy streams as JAX's chunked engine, those within PROMPT_LEN
    also the port's whole-prompt engine's; no graph is captured after
    warm-up."""
    kw = dict(prompt_len=8, max_new_tokens=6, batch_tiles=[1, 2], cache_tiles=[16, 32])
    prompts = _prompts(12, [1, 3, 4, 5, 7, 8, 20])
    eng = _port(target, chunk_prefill=4, **kw)
    n0 = eng.n_compiles
    got = _streams(eng, prompts)
    assert eng.n_compiles == n0
    st = eng.stats()
    assert st["chunk_prefill"] == 4 and st["chunk_prefills"] == len(prompts)
    assert st["chunk_calls"] == sum(-(-len(p) // 4) for p in prompts)
    assert got == _streams(_jax(target, chunk_prefill=4, **kw), prompts)
    assert got[:-1] == _streams(_port(target, **kw), prompts[:-1])
    assert all(len(s) == 6 for s in got)


def test_chunked_submit_bound_matches_jax(target):
    kw = dict(prompt_len=8, max_new_tokens=6, batch_tiles=[2], cache_tiles=[16],
              chunk_prefill=4)
    msgs = []
    for eng in (_port(target, **kw), _jax(target, **kw)):
        with pytest.raises(ValueError, match=r"11 \+ max_new=6 > largest") as e:
            eng.submit(np.arange(11, dtype=np.int32))
        msgs.append(str(e.value))
        eng.drain()
    assert msgs[0] == msgs[1]


def test_a_stream_held_between_tokens_does_not_block_the_engine(target):
    """Three streams each iterated to their first token, then drained in
    turn: the scheduler keeps emitting into streams whose iterators are
    suspended (the iterator holds no lock across a yield)."""
    eng = _port(target, prompt_len=8, max_new_tokens=6, batch_tiles=[1, 2],
                cache_tiles=[16]).start()
    try:
        streams = [eng.submit(p) for p in _prompts(3, [2, 4, 6])]
        iters = [iter(s) for s in streams]
        heads = [next(it) for it in iters]
        outs = [[h, *it] for h, it in zip(heads, iters)]
    finally:
        eng.drain()
    assert [len(o) for o in outs] == [6, 6, 6]


# --------------------------------------------------------- length classes


def _decisions(mod, script, max_queue=4, long_max_queue=2):
    """Each (depth, length class, class depth) of ``script`` through the
    package's AdmissionController: 'ok' or the error's type and text."""
    ctrl = mod.AdmissionController(max_queue, long_max_queue=long_max_queue)
    out = []
    for depth, lc, cd in script:
        try:
            ctrl.admit(depth, 123.0, length_class=lc, class_depth=cd)
            out.append("ok")
        except mod.QueueFullError as e:
            out.append((type(e).__name__, str(e), e.depth, e.max_queue, e.retry_after_ms,
                        getattr(e, "length_class", None)))
    ctrl.close()
    with pytest.raises(mod.EngineClosedError):
        ctrl.admit(0, 1.0)
    return out


def test_admission_decisions_and_messages_match_jax():
    script = [(0, "short", 0), (1, "long", 0), (1, "long", 1), (2, "long", 2),
              (3, "short", 2), (4, "short", 2), (4, "long", 0), (2, "long", 3)]
    got = _decisions(tadm, script)
    assert got == _decisions(jadm, script)
    assert got[3][0] == "LongQueueFullError" and got[5][0] == "QueueFullError"
    for args in ((4, 4), (4, 8), (4, -1), (0, 0)):
        errs = []
        for mod in (tadm, jadm):
            with pytest.raises(ValueError) as e:
                mod.AdmissionController(args[0], long_max_queue=args[1])
            errs.append(str(e.value))
        assert errs[0] == errs[1], args


def _engine_script(eng, prompts):
    out = []
    for p in prompts:
        try:
            eng.submit(p)
            out.append("ok")
        except Exception as e:  # noqa: BLE001 — compared by type and text
            out.append((type(e).__name__, str(e)))
    st = eng.stats()
    out.append({k: st[k] for k in ("queue_depth", "queue_depth_long", "long_threshold",
                                    "long_max_queue", "long_admitted", "long_rejected")})
    return out


def test_engine_length_classes_match_jax(target):
    """A scripted burst into an engine not yet started (the queue holds):
    long prompts past the class's reservation are refused with the class's
    error, short ones keep being admitted up to the total bound, as in
    JAX's engine, decision for decision and message for message; then
    every admitted request completes."""
    kw = dict(prompt_len=8, max_new_tokens=3, batch_tiles=[2], cache_tiles=[32],
              chunk_prefill=4, max_queue=4, long_prompt_threshold=8, long_max_queue=2)
    long_p, short_p = _prompts(21, [10, 3])
    script = [long_p, long_p, long_p, short_p, short_p, short_p, long_p]
    eng = _port(target, **kw)
    jeng = _jax(target, **kw)
    got = _engine_script(eng, script)
    assert got == _engine_script(jeng, script)
    assert [g if g == "ok" else g[0] for g in got[:-1]] == [
        "ok", "ok", "LongQueueFullError", "ok", "ok", "QueueFullError", "QueueFullError"]
    jeng.drain()
    eng.start()
    eng.drain()
    assert eng.stats()["retired"] == 4


def test_long_class_frame_is_the_queue_full_frame_of_jax(target):
    kw = dict(prompt_len=8, max_new_tokens=3, batch_tiles=[2], cache_tiles=[32],
              chunk_prefill=4, max_queue=3, long_prompt_threshold=8, long_max_queue=1)
    frames = []
    for eng, svc in ((_port(target, **kw), tservice), (_jax(target, **kw), jservice)):
        eng.submit(np.arange(10, dtype=np.int32))  # fills the reservation
        sent = []
        svc.handle_generate(eng, {"tokens": list(range(12))}, sent.append)
        frames.append([json.loads(b) for b in sent])
        eng.drain()
    assert frames[0] == frames[1]
    assert set(frames[0][0]) == {"error", "retry_after_ms"}


def test_reservation_without_threshold_refused_as_jax(target):
    msgs = []
    for make in (_port, _jax):
        with pytest.raises(ValueError, match="without SERVE.LONG_PROMPT_THRESHOLD") as e:
            make(target, prompt_len=8, max_new_tokens=3, batch_tiles=[2],
                 cache_tiles=[32], max_queue=4, long_max_queue=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------- speculative decode


@pytest.mark.parametrize("args", [
    (0, 320, 32, 8, 6, [16]), (4, 64, 32, 8, 6, [16]), (4, 320, 32, 8, 6, [16]),
    (4, 320, 16, 8, 6, [32])])
def test_speculate_refusals_match_jax_letter_for_letter(args):
    k, dvocab, dseq, plen, max_new, tiles = args
    tgt = SimpleNamespace(vocab_size=320, seq_len=32)
    dft = SimpleNamespace(vocab_size=dvocab, seq_len=dseq)
    msgs = []
    for mod in (tgen, jgen):
        with pytest.raises(ValueError) as e:
            mod.validate_speculate_cfg(k, tgt, dft, plen, max_new, tiles)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    tgen.validate_speculate_cfg(4, tgt, SimpleNamespace(vocab_size=320, seq_len=32), 8, 6,
                                [32])


SPEC = dict(prompt_len=8, max_new_tokens=10, batch_tiles=[1, 2], cache_tiles=[32])
SPEC_PROMPTS = [2, 5, 8]


@pytest.fixture(scope="module")
def target_only(target):
    """The port's target-only greedy streams of the speculative prompts."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return _streams(_port(target, **SPEC), _prompts(8, SPEC_PROMPTS))
    finally:
        torch.set_num_threads(before)


def test_speculative_greedy_identical_to_target_only_and_jax(target, draft, target_only):
    """A disagreeing draft at K=3: the port's greedy streams equal its
    target-only ones and JAX's speculative engine's; the round counters
    add up; no graph is captured after warm-up."""
    prompts = _prompts(8, SPEC_PROMPTS)
    eng = _port(target, draft, spec_k=3, **SPEC)
    n0 = eng.n_compiles
    got = _streams(eng, prompts)
    assert got == target_only
    assert got == _streams(_jax(target, draft, spec_k=3, **SPEC), prompts)
    st = eng.stats()
    assert eng.n_compiles == n0 and st["spec_rounds"] > 0
    assert st["spec_proposed"] == 3 * st["spec_rounds"]  # one request at a time
    assert 0 <= st["spec_accepted"] < st["spec_proposed"] and st["spec_rejected"] > 0


def test_self_draft_accepts_every_proposal(target, target_only):
    """The target drafting for itself: no proposal is rejected (every
    round but a request's last earns the bonus; the last ends at
    max_new_tokens), the stream is the target-only one."""
    prompts = _prompts(8, SPEC_PROMPTS)
    eng = _port(target, target, spec_k=3, **SPEC)
    assert _streams(eng, prompts) == target_only
    st = eng.stats()
    assert st["spec_rejected"] == 0 and st["spec_accepted"] > 0
    assert st["spec_bonus"] == st["spec_rounds"] - len(prompts)


def test_speculative_sampled_stream_matches_jax(target, draft):
    """A sampled request at a fixed seed (the per-step propose path, host
    float64 selection) gives JAX's speculative stream, and replays."""
    kw = dict(prompt_len=8, max_new_tokens=10, batch_tiles=[1], cache_tiles=[32], spec_k=3)
    got = _streams(_port(target, draft, **kw), [[4, 8, 15]], sample=SAMPLE)
    assert got == _streams(_port(target, draft, **kw), [[4, 8, 15]], sample=SAMPLE)
    assert got == _streams(_jax(target, draft, **kw), [[4, 8, 15]], sample=SAMPLE)
    assert len(got[0]) == 10


def test_chunked_prefill_composes_with_speculation(target, draft):
    """Chunk-admitted requests speculate off a mirrored draft page: greedy
    streams equal target-only decode (a 24-token prompt tile) and JAX's
    chunked speculative engine, for prompts short and past PROMPT_LEN."""
    prompts = _prompts(14, [3, 6, 11])
    plain = _streams(_port(target, prompt_len=24, max_new_tokens=5, batch_tiles=[1],
                           cache_tiles=[32]), prompts)
    kw = dict(prompt_len=8, max_new_tokens=5, batch_tiles=[1], cache_tiles=[32],
              chunk_prefill=4, spec_k=2)
    eng = _port(target, draft, **kw)
    got = _streams(eng, prompts)
    assert got == plain == _streams(_jax(target, draft, **kw), prompts)
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["chunk_prefills"] == 3
    assert st["chunk_calls"] == 2 * sum(-(-len(p) // 4) for p in prompts)


def test_engine_from_cfg_builds_the_draft(tmp_path):
    """GENERATE.SPECULATE on the CPU at gpt_nano's width (32 positions):
    DRAFT_ARCH gpt_nano from the same RNG_SEED is the target itself
    (every proposal accepted); DRAFT_WEIGHTS loads a .pth (a seed-1
    model) in its place."""
    tconfig.merge_from_file("config/gpt_nano.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "LM.SEQ_LEN", 32, "GENERATE.PROMPT_LEN", 8,
                          "GENERATE.MAX_NEW_TOKENS", 8, "GENERATE.BATCH_TILES", [1],
                          "GENERATE.SPECULATE.ENABLED", True,
                          "GENERATE.SPECULATE.DRAFT_ARCH", "gpt_nano",
                          "GENERATE.SPECULATE.K", 3, "GENERATE.EOS_ID", -1,
                          "OUT_DIR", str(tmp_path)])
    eng = tservice.engine_from_cfg()
    assert eng.spec_k == 3
    for a, b in zip(eng.model.state_dict().values(), eng.draft_model.state_dict().values()):
        assert torch.equal(a, b)
    _streams(eng, [[1, 2, 3]])
    st = eng.stats()
    assert st["spec_rejected"] == 0 and st["spec_accepted"] > 0
    other = build_model("gpt_nano", num_classes=320, dtype=torch.float32, seq_len=32,
                        generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "draft.pth")
    torch.save(other.state_dict(), path)
    tcfg.GENERATE.SPECULATE.DRAFT_WEIGHTS = path
    eng = tservice.engine_from_cfg()
    for a, b in zip(other.state_dict().values(), eng.draft_model.state_dict().values()):
        assert torch.equal(a.to(b.dtype), b)
    eng.drain()
