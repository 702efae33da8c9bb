"""KV-cache generation with continuous batching (counterpart of
distribuuuu_tpu/lm/generate.py, without tensor-parallel decode).

**Prefill/decode split.** A prompt runs once through the decoder against
an empty cache (whole prompt, padded to a power-of-two prompt tile); that
gives its K/V and the first generated token. Every later token is a
decode step: one token per sequence against the cached K/V.

**Paged per-request KV cache** ``{"k", "v"}: [L, B, H, C, D]`` in the
compute dtype, one page (row) per request slot: admitting a request
overwrites its page, retiring frees the slot without moving data. Where
the JAX package returns a new cache from each step, the port writes the
cache in place (one cache a tile in device memory, no copy a step).

**(batch, cache-len) tiles, one graph each.** A step runs the smallest
tile covering the live slots and the longest sequence; crossing a tile
boundary copies the live rows into the next tile's cache once. The JAX
engine compiles every tile ahead of time; the port captures every tile as
one CUDA graph (``graphs.StepGraph``: a warm-up call, then the capture, on
the engine's own memory pool), in the scheduler thread, before it serves
(PyTorch keeps cuBLAS handles per thread). Each tile's cache is a static
buffer its graphs share (the decode step and, under speculation, the
verify step read and write the same one); each graph owns its tokens and
lengths, each prompt or chunk tile its page; a step copies its inputs in
and replays. On the CPU the same bodies run eagerly on the same buffers.
``n_compiles`` counts the graphs captured (warmed, on the CPU).

**Chunked paged prefill** (``chunk_prefill`` > 0) replaces the prompt
tiles by one fixed-width chunk graph a cache tile: the prompt streams into
a B=1 page ``W`` tokens a call, each chunk attending the page written so
far through the dense region; the final chunk is padded (its pad K/V land
past the prompt, where the ragged mask never looks and the decode writes
overwrite them), and the first token comes off the last chunk's logit
row. A prompt may then exceed ``prompt_len`` up to what the largest cache
tile holds next to its decode budget.

**Length classes.** Prompts of at least ``long_prompt_threshold`` tokens
are the "long" class, which may hold at most ``long_max_queue`` of the
queue (``serve/admission.py``); short requests keep being admitted.

**Speculative decoding** (``draft_model``). Each round the draft proposes
K tokens per slot through T=1 decode steps against its own paged cache
(the decode-attention kernel on the card), the target verifies
``[last, d_1..d_K]`` in one T=K+1 call through the dense region, and the
acceptance rule keeps the longest agreeing prefix plus one corrective or
bonus token. An all-greedy round runs the K (or K+1) draft steps as one
graph with the argmax fed back on the device (JAX's fused propose); a
round with a sampled slot runs them one graph call a step, selecting on
the host in float64. Rejection costs nothing in either cache: positions
past a slot's length are invisible and overwritten by the next write.

**The decode step's attention.** ``CachedAttention`` applies the GPT's own
``blocks.N.attn`` modules (there is no second copy of the parameters).
At T = 1, when ``decode_attn.supported`` holds for the cache tile, the
step goes through ``ops/cuda/decode_attn.decode_attention`` (the kernel on
the card); otherwise, and for every prefill, chunk and verify call, it
runs the dense fp32 region, as the JAX package does.

**Continuous batching.** The scheduler admits and retires per decode
step; tokens stream to each requester the step they are produced
(:class:`GenStream`).

**Sampling** is host numpy, the JAX package's functions verbatim, so a
seed replays the same stream in both, speculative rounds included.

**Telemetry** (the JAX engine's records, from the scheduler thread, outside
every graph: a record in a graph's body would fire once, at capture): a
``gen.admit`` and a ``gen.prefill`` (or ``gen.chunk_prefill``) a request,
``gen.sample`` for a sampled one, ``gen.decode`` a step (``gen.speculate``
a round), ``gen.retire`` a retirement, each ``ms`` from the engine's own
host clocks; ``lm.tokens`` (the running counters) every
``serve/engine.EMIT_INTERVAL_S`` and at the drain; the warm-up's captures in the
registry's ``serve.aot_compiles``, and the ledger of each decode tile
(``gen_decode_b{b}_c{c}``) and prompt or chunk tile (``gen_prefill_p{p}``,
``gen_chunk_prefill_w{W}_c{c}``), phase ``"generate"``. A traced request (``submit(trace=...)``,
``telemetry/tracectx.py``) takes the trace id as its ``request_id`` and
lands its ``trace.span`` tree: ``queue_wait``, ``prefill`` or
``chunk_prefill``, a ``decode_step`` or ``spec_round`` for each step it
was live in, and the ``engine.request`` root at retire.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque

import numpy as np
import torch

from distribuuuu_tpu_torch import graphs
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.ops.cuda import decode_attn
from distribuuuu_tpu_torch.serve.admission import (
    AdmissionController,
    EngineClosedError,
    QueueFullError,
)
from distribuuuu_tpu_torch.serve.engine import COMPILE_EVENTS, EMIT_INTERVAL_S
from distribuuuu_tpu_torch.telemetry import costmodel
from distribuuuu_tpu_torch.telemetry import registry as telemetry_registry
from distribuuuu_tpu_torch.telemetry import spans as telemetry_spans
from distribuuuu_tpu_torch.telemetry import tracectx


# --------------------------------------------------------- decode modules


def _step_index(lengths: torch.Tensor, t: int, c: int, dense: bool):
    """Per step, shared by every layer: where the T new tokens' K/V go
    (``(rows [B, 1], positions [B, T])``, the start clamped to ``[0, C − T]``
    so the update fits, as ``jax.lax.dynamic_update_slice`` clamps it) and,
    for the dense region only, which keys each new token sees
    (``kpos ≤ lengths[b] + t``, ``[B, 1, T, C]``)."""
    dev = lengths.device
    lens = lengths.long()
    steps = torch.arange(t, device=dev)
    start = lens.clamp(0, c - t)
    where = (torch.arange(lens.shape[0], device=dev)[:, None], start[:, None] + steps[None, :])
    if not dense:
        return where, None
    kpos = torch.arange(c, device=dev)
    return where, kpos[None, None, None, :] <= (lens[:, None] + steps[None, :])[:, None, :, None]


class CachedAttention:
    """``vit.Attention``'s math against a KV cache, through the module's
    own ``qkv``/``proj``: the T new tokens' K/V are written (in place) at
    each row's length; with ``visible`` None the T=1 step runs the
    decode-attention kernel, else the dense fp32 region under that mask."""

    def __init__(self, attn, decode_block: int):
        self.attn = attn
        self.blk = decode_block

    def __call__(self, x, cache_k, cache_v, lengths, where, visible):
        b, t, dim = x.shape
        h = self.attn.num_heads
        d = dim // h
        qkv = self.attn.qkv(x).reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, H, T, D]
        cache_k[where[0], :, where[1]] = k.transpose(1, 2)
        cache_v[where[0], :, where[1]] = v.transpose(1, 2)
        scale = d ** -0.5
        dtype = self.attn.dtype
        if visible is None:
            out = decode_attn.decode_attention(q[:, :, 0, :], cache_k, cache_v, lengths,
                                               scale=scale, blk_k=self.blk)  # fp32 [B, H, D]
            return self.attn.proj(out.to(dtype).reshape(b, t, dim))
        s = torch.einsum("bhtd,bhcd->bhtc", q.float(), cache_k.float()) * scale
        w = torch.softmax(torch.where(visible, s, -1e30), dim=-1)
        out = torch.einsum("bhtc,bhcd->bhtd", w, cache_v.float())
        return self.attn.proj(out.to(dtype).transpose(1, 2).reshape(b, t, dim))


class GPTDecoder:
    """Applies a ``models/gpt.GPT`` to T new tokens per row against a KV
    cache: ``lengths[b]`` tokens are already cached for row b, positions
    are ``clip(lengths + arange(T), 0, seq_len − 1)``. Returns the logits
    ``[B, T, vocab]`` (head dtype); the cache is updated in place. The
    decode-attention kernel takes the step when ``decode_attn.supported``
    holds for (T, cache tile, head dim, ``KERNELS.DECODE_BLOCK``)."""

    def __init__(self, model, decode_block: int | None = None):
        self.model = model
        self.blk = int(cfg.KERNELS.DECODE_BLOCK if decode_block is None else decode_block)
        self.attns = [CachedAttention(b.attn, self.blk) for b in model.blocks]

    def __call__(self, tokens, lengths, cache):
        m = self.model
        t, c = tokens.shape[1], cache["k"].shape[3]
        kernel = decode_attn.supported(t, c, m.dim // m.num_heads, self.blk)[0]
        where, visible = _step_index(lengths, t, c, dense=not kernel)
        steps = torch.arange(t, device=tokens.device)[None, :]
        x = m.embed(tokens, (lengths.long()[:, None] + steps).clamp(0, m.seq_len - 1))
        for i, blk in enumerate(m.blocks):
            x = x + self.attns[i](blk.norm1(x), cache["k"][i], cache["v"][i], lengths, where,
                                  visible)
            x = x + blk.mlp(blk.norm2(x))
        return m.logits(x)


def decoder_for(model) -> GPTDecoder:
    """The decoder over a GPT's own modules."""
    return GPTDecoder(model)


# ----------------------------------------------------------- tile algebra


def default_tiles(cap: int) -> list[int]:
    """Powers of two up to ``cap`` plus ``cap`` itself (the serve-bucket
    rule, serve/engine.default_buckets)."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(int(cap))
    return sorted(set(out))


def tile_for(tiles: list[int], n: int) -> int:
    """Smallest tile ≥ n (tiles sorted ascending)."""
    for t in tiles:
        if t >= n:
            return t
    raise ValueError(f"no tile covers {n} (tiles: {tiles})")


def validate_generate_cfg(seq_len: int, prompt_len: int, max_new: int,
                          batch_tiles: list[int], cache_tiles: list[int]):
    """The GENERATE config refusals, with the exact arithmetic in each
    message (the JAX package's). Returns (batch_tiles, cache_tiles)."""
    if prompt_len < 1 or max_new < 1:
        raise ValueError(
            f"GENERATE.PROMPT_LEN={prompt_len} and MAX_NEW_TOKENS={max_new} "
            "must be >= 1"
        )
    batch_tiles = sorted(set(int(b) for b in batch_tiles)) or default_tiles(4)
    cache_tiles = sorted(set(int(c) for c in cache_tiles)) or [int(seq_len)]
    if batch_tiles[0] < 1:
        raise ValueError(f"GENERATE.BATCH_TILES {batch_tiles} must be >= 1")
    for c in cache_tiles:
        if c > seq_len:
            raise ValueError(
                f"GENERATE.CACHE_TILES contains {c} > LM.SEQ_LEN={seq_len}: "
                "the learned position table has no entry past the trained "
                "context — lower the tile or retrain with a longer LM.SEQ_LEN"
            )
    need = prompt_len + max_new
    if cache_tiles[-1] < need:
        raise ValueError(
            f"largest GENERATE.CACHE_TILES entry {cache_tiles[-1]} cannot "
            f"hold a full request: GENERATE.PROMPT_LEN={prompt_len} + "
            f"MAX_NEW_TOKENS={max_new} = {need} cached positions — raise "
            f"CACHE_TILES to >= {need} (and <= LM.SEQ_LEN={seq_len}) or "
            "lower MAX_NEW_TOKENS/PROMPT_LEN"
        )
    return batch_tiles, cache_tiles


def validate_chunk_prefill_cfg(chunk: int, cache_tiles: list[int]):
    """The GENERATE.CHUNK_PREFILL refusals, exact arithmetic in-message (the
    JAX package's): the final chunk is padded and writes
    ``ceil(plen/chunk)*chunk`` page positions, so every cache tile wide
    enough to be a page must be a multiple of the chunk."""
    if chunk < 1:
        raise ValueError(
            f"GENERATE.CHUNK_PREFILL={chunk} must be >= 1 (0 disables "
            "chunked prefill)"
        )
    if chunk > cache_tiles[-1]:
        raise ValueError(
            f"GENERATE.CHUNK_PREFILL={chunk} exceeds the largest "
            f"GENERATE.CACHE_TILES entry {cache_tiles[-1]} — no page "
            f"could hold even one chunk; lower CHUNK_PREFILL to "
            f"<= {cache_tiles[-1]} or raise CACHE_TILES"
        )
    for c in cache_tiles:
        if c >= chunk and c % chunk:
            raise ValueError(
                f"GENERATE.CHUNK_PREFILL={chunk} does not divide "
                f"GENERATE.CACHE_TILES entry {c} ({c} % {chunk} = "
                f"{c % chunk}) — the final padded chunk writes "
                f"ceil(plen/{chunk})*{chunk} positions into its page, "
                f"which can spill past a {c}-wide tile; use cache tiles "
                f"that are multiples of {chunk} (e.g. {c - c % chunk} or "
                f"{c + chunk - c % chunk}) or a CHUNK_PREFILL that "
                f"divides every tile"
            )


# --------------------------------------------------------------- sampling
#
# Greedy (temperature <= 0) is argmax and draws nothing. A sampled decision
# consumes one counter-based uniform ``_uniform(seed, stream, n)``, ``n`` a
# per-request per-stream draw counter, so a seed replays the same stream
# however requests were batched. One stream a decision kind: plain decode,
# speculative acceptance, draft proposal, residual resample.

_U_PLAIN, _U_ACCEPT, _U_DRAFT, _U_RESID = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SampleParams:
    """Per-request selection knobs (``GENERATE.SAMPLE`` defaults; the
    ``op="generate"`` ctrl frame may override all four per request)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def validate_sample_cfg(temperature: float, top_k: int, top_p: float):
    """The GENERATE.SAMPLE refusals (exact values in-message)."""
    if temperature < 0.0:
        raise ValueError(
            f"GENERATE.SAMPLE.TEMPERATURE={temperature} must be >= 0 "
            "(0 = greedy argmax)"
        )
    if top_k < 0:
        raise ValueError(
            f"GENERATE.SAMPLE.TOP_K={top_k} must be >= 0 (0 = disabled)"
        )
    if not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"GENERATE.SAMPLE.TOP_P={top_p} must lie in (0, 1] "
            "(1.0 = disabled)"
        )


def sample_params(obj: SampleParams | dict | None = None) -> SampleParams:
    """Request-side sampling knobs: a :class:`SampleParams` passes through,
    a dict (the ctrl-frame fields) overlays the ``GENERATE.SAMPLE``
    defaults, ``None`` is the defaults. Validated."""
    if isinstance(obj, SampleParams):
        sp = obj
    else:
        d = dict(obj or {})
        node = cfg.GENERATE.SAMPLE
        sp = SampleParams(
            temperature=float(d.get("temperature", node.TEMPERATURE)),
            top_k=int(d.get("top_k", node.TOP_K)),
            top_p=float(d.get("top_p", node.TOP_P)),
            seed=int(d.get("seed", node.SEED)),
        )
    validate_sample_cfg(sp.temperature, sp.top_k, sp.top_p)
    return sp


def _uniform(seed: int, stream: int, n: int) -> float:
    """The (seed, stream, n) → [0, 1) uniform of one sampled decision: a
    fresh Philox generator per draw, a pure function of its coordinates."""
    return float(
        np.random.default_rng(
            [int(seed) % (2 ** 63), int(stream), int(n)]
        ).random()
    )


def warp_probs(logits, sp: SampleParams) -> np.ndarray:
    """Temperature / top-k / top-p warped probabilities of one logit row
    (float64 numpy, ties broken by vocab id)."""
    x = np.asarray(logits, np.float64) / float(sp.temperature)
    if sp.top_k and sp.top_k < x.size:
        x = np.where(x >= np.sort(x)[-sp.top_k], x, -np.inf)
    x = x - x.max()
    p = np.exp(x)
    p /= p.sum()
    if sp.top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        cut = int(np.searchsorted(np.cumsum(p[order]), sp.top_p)) + 1
        keep = order[:cut]
        masked = np.zeros_like(p)
        masked[keep] = p[keep]
        p = masked / masked.sum()
    return p


def _pick(p: np.ndarray, u: float) -> int:
    """Inverse-CDF selection in vocab-id order."""
    cum = np.cumsum(p)
    return int(min(np.searchsorted(cum, u * cum[-1], side="right"),
                   p.size - 1))


def sample_token(logits, sp: SampleParams, u: float | None = None) -> int:
    """One token from one logit row: greedy argmax when
    ``sp.temperature <= 0`` (``u`` unused), else inverse-CDF over the
    warped distribution with the caller-supplied uniform."""
    if sp.greedy:
        return int(np.asarray(logits).argmax())
    return _pick(warp_probs(logits, sp), u)


def validate_speculate_cfg(k: int, target_model, draft_model, prompt_len: int,
                           max_new: int, cache_tiles: list[int]):
    """The GENERATE.SPECULATE refusals, exact arithmetic in-message (the
    JAX package's): the draft/target pairing, and K positions of headroom
    in the largest cache tile (a round may write K+1 past a length)."""
    if k < 1:
        raise ValueError(f"GENERATE.SPECULATE.K={k} must be >= 1")
    tv, dv = int(target_model.vocab_size), int(draft_model.vocab_size)
    if tv != dv:
        raise ValueError(
            f"GENERATE.SPECULATE draft/target vocab mismatch: draft "
            f"vocab_size={dv} != target vocab_size={tv} — the accept/"
            "reject rule compares the two distributions token by token, "
            "which is undefined across vocabularies"
        )
    need = prompt_len + max_new + k
    if cache_tiles[-1] < need:
        raise ValueError(
            f"largest GENERATE.CACHE_TILES entry {cache_tiles[-1]} cannot "
            f"hold a speculative round: GENERATE.PROMPT_LEN={prompt_len} + "
            f"MAX_NEW_TOKENS={max_new} + SPECULATE.K={k} = {need} cached "
            f"positions — raise CACHE_TILES to >= {need} or lower "
            "K/MAX_NEW_TOKENS/PROMPT_LEN"
        )
    ds = int(draft_model.seq_len)
    if cache_tiles[-1] > ds:
        raise ValueError(
            f"GENERATE.CACHE_TILES largest entry {cache_tiles[-1]} exceeds "
            f"the draft model's trained context LM.SEQ_LEN={ds}: the draft "
            "mirrors every cached position and its learned position table "
            "has no entry past that — use a draft trained for the context "
            "or lower the cache tiles"
        )


# -------------------------------------------------------------- the engine


class GenStream:
    """Per-request streamed result: iterate for tokens as they decode, or
    ``result()`` for the full list. Closed exactly once at retire.
    ``request_id`` is the engine's counter, or a traced request's trace
    id; ``span_id`` (minted now, so the children can parent onto it) is
    its ``engine.request`` root span."""

    def __init__(self, request_id, prompt_len: int, trace=None):
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.trace = trace
        self.t_submit = time.perf_counter()
        self.span_id = "" if trace is None else tracectx.new_span_id()
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._done = False
        self._error: Exception | None = None
        self.reason: str | None = None

    # engine side
    def _emit(self, token: int) -> None:
        with self._cond:
            self._q.append(int(token))
            self._cond.notify_all()

    def _close(self, reason: str, error: Exception | None = None) -> None:
        with self._cond:
            self._done = True
            self.reason = reason
            self._error = error
            self._cond.notify_all()

    # client side
    def __iter__(self):
        # the lock is released before each yield: a consumer that holds the
        # iterator between tokens must not block the scheduler's _emit
        while True:
            with self._cond:
                while not self._q and not self._done:
                    self._cond.wait(timeout=0.1)
                token = self._q.popleft() if self._q else None
                error = self._error
            if token is not None:
                yield token
                continue
            if error is not None:
                raise error
            return

    def result(self, timeout: float | None = 60.0) -> list[int]:
        deadline = None if timeout is None else time.perf_counter() + timeout
        out = []
        with self._cond:
            while True:
                out.extend(self._q)
                self._q.clear()
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return out
                wait = (
                    None if deadline is None
                    else max(0.0, deadline - time.perf_counter())
                )
                if wait == 0.0:
                    raise TimeoutError(
                        f"generation {self.request_id} incomplete after "
                        f"{timeout}s"
                    )
                self._cond.wait(timeout=wait)


class _Slot:
    __slots__ = ("stream", "length", "last_token", "new_tokens", "max_new",
                 "sample", "draws", "history", "draft_len")

    def __init__(self, stream, length, last_token, max_new, sample):
        self.stream = stream
        self.length = length          # cached positions (prompt + generated-1)
        self.last_token = last_token  # feeds the next decode step
        self.new_tokens = 0
        self.max_new = max_new
        self.sample = sample          # SampleParams for this request
        self.draws = [0, 0, 0, 0]     # per-stream uniform draw counters
        self.history: list[int] = []  # prompt + emitted tokens (the draft's feed)
        self.draft_len = 0            # positions the draft's cache holds


class GenerateEngine:
    """Continuous-batching generation of a GPT on one device.

    ``model`` is a ``models/gpt.GPT``; it is moved to ``device``, put in
    eval and prepared (compute-dtype weights cast once) here, and so is
    ``draft_model`` (speculative decoding, ``spec_k`` proposals a round).
    Every graph (decode, verify, draft and propose tiles; prompt or chunk
    tiles) runs once in the scheduler thread during construction;
    ``start()`` lets it serve; ``submit`` returns a :class:`GenStream`."""

    def __init__(
        self,
        model,
        *,
        device,
        max_new_tokens: int | None = None,
        prompt_len: int | None = None,
        batch_tiles: list[int] | None = None,
        cache_tiles: list[int] | None = None,
        eos_id: int | None = None,
        max_queue: int | None = None,
        long_prompt_threshold: int | None = None,
        long_max_queue: int | None = None,
        poll_s: float | None = None,
        draft_model=None,
        spec_k: int | None = None,
        sample: SampleParams | dict | None = None,
        chunk_prefill: int | None = None,
        graphed: bool | None = None,
    ):
        self.device = torch.device(device)
        self.max_new = int(
            max_new_tokens if max_new_tokens is not None
            else cfg.GENERATE.MAX_NEW_TOKENS
        )
        self.prompt_len = int(
            prompt_len if prompt_len is not None else cfg.GENERATE.PROMPT_LEN
        )
        self.eos_id = int(eos_id if eos_id is not None else cfg.GENERATE.EOS_ID)
        self._poll_s = float(poll_s if poll_s is not None else cfg.GENERATE.POLL_S)
        self.batch_tiles, self.cache_tiles = validate_generate_cfg(
            model.seq_len, self.prompt_len, self.max_new,
            list(batch_tiles if batch_tiles is not None else cfg.GENERATE.BATCH_TILES),
            list(cache_tiles if cache_tiles is not None else cfg.GENERATE.CACHE_TILES),
        )
        self.chunk_prefill = int(
            chunk_prefill if chunk_prefill is not None else cfg.GENERATE.CHUNK_PREFILL
        )
        if self.chunk_prefill:
            validate_chunk_prefill_cfg(self.chunk_prefill, self.cache_tiles)
        self._default_sample = sample_params(sample)
        self.spec_k = 0
        if draft_model is not None:
            k = int(spec_k if spec_k is not None else cfg.GENERATE.SPECULATE.K)
            validate_speculate_cfg(k, model, draft_model, self.prompt_len, self.max_new,
                                   self.cache_tiles)
            self.spec_k = k
        self.long_threshold = int(
            long_prompt_threshold if long_prompt_threshold is not None
            else cfg.SERVE.LONG_PROMPT_THRESHOLD
        )
        self._admission = AdmissionController(
            max_queue if max_queue is not None else cfg.SERVE.MAX_QUEUE,
            long_max_queue=int(long_max_queue if long_max_queue is not None
                               else cfg.SERVE.LONG_MAX_QUEUE),
        )
        if self._admission.long_max_queue and not self.long_threshold:
            raise ValueError(
                f"SERVE.LONG_MAX_QUEUE={self._admission.long_max_queue} "
                "without SERVE.LONG_PROMPT_THRESHOLD — the long-class "
                "reservation needs the prompt-token threshold that "
                "defines the long class (set SERVE.LONG_PROMPT_THRESHOLD "
                ">= 1)"
            )
        self.prompt_tiles = default_tiles(self.prompt_len)
        # chunked prefill: one chunk graph per cache tile wide enough to be a page
        self.page_tiles = ([c for c in self.cache_tiles if c >= self.chunk_prefill]
                           if self.chunk_prefill else self.prompt_tiles)
        self.n_slots = self.batch_tiles[-1]

        if self.device.type == "cuda" and model.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        self.model = model.to(self.device).eval().prepare()
        self.decoder = decoder_for(self.model)
        self.draft_model = self.draft_decoder = None
        if self.spec_k:
            self.draft_model = draft_model.to(self.device).eval().prepare()
            self.draft_decoder = decoder_for(self.draft_model)
        self.vocab_size = model.vocab_size

        self._lock = threading.Condition()
        self._waiting: deque = deque()
        self._slots: list[_Slot | None] = [None] * self.n_slots
        self._b_tile = self.batch_tiles[0]
        self._c_tile = self.cache_tiles[0]
        # on the card every tile is a graph; graphed=False runs the bodies
        # eagerly (only to measure the graphs against them)
        self.graphed = graphs.graphed(self.device) if graphed is None else graphed
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._caches: dict = {}   # (b, c, draft) -> the tile's static cache
        self._graphs: dict = {}   # (kind, shape...) -> StepGraph
        self._cache = self._cache_of(self._b_tile, self._c_tile)
        self._draft_cache = (self._cache_of(self._b_tile, self._c_tile, True)
                             if self.spec_k else None)
        self._draining = False
        self._started = False
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._counters = {
            "prompt_tokens": 0, "new_tokens": 0, "decode_steps": 0,
            "requests": 0, "retired": 0,
        }
        if self.spec_k:
            # spec_rejected (the port's addition) counts the proposals the
            # target refused; proposals left when a request retires mid-round
            # are neither, so accepted / (accepted + rejected) is the rate
            self._counters.update(spec_rounds=0, spec_proposed=0, spec_accepted=0,
                                  spec_bonus=0, spec_rejected=0)
        if self.chunk_prefill:
            self._counters.update(chunk_prefills=0, chunk_calls=0)
        if self.long_threshold:
            self._counters.update(long_admitted=0, long_rejected=0)
        self._decode_ms: deque = deque(maxlen=4096)
        self._prefill_ms: deque = deque(maxlen=1024)

        # -- warm every graph once, in the thread that serves ----------------
        self.n_compiles = 0
        self._tiles = [(b, c) for b in self.batch_tiles for c in self.cache_tiles]
        self._warm_error: BaseException | None = None
        self._warmed = threading.Event()
        self._go = threading.Event()
        self._thread = threading.Thread(
            target=self._scheduler, name="gen-scheduler", daemon=True
        )
        self._thread.start()
        self._warmed.wait()
        if self._warm_error is not None:
            raise self._warm_error

    # -------------------------------------------------------------- device
    def _zero_cache(self, b: int, c: int, draft: bool = False) -> dict:
        m = self.draft_model if draft else self.model
        shape = (m.depth, b, m.num_heads, c, m.dim // m.num_heads)
        return {k: torch.zeros(shape, dtype=m.dtype, device=self.device)
                for k in ("k", "v")}

    def _cache_of(self, b: int, c: int, draft: bool = False) -> dict:
        """Tile ``(b, c)``'s static cache (the target's, or the draft's),
        shared by every graph of that tile."""
        key = (b, c, draft)
        if key not in self._caches:
            self._caches[key] = self._zero_cache(b, c, draft)
        return self._caches[key]

    def _graph(self, key: tuple, body, inputs: dict) -> graphs.StepGraph:
        g = self._graphs[key] = graphs.StepGraph(body, inputs, device=self.device,
                                                 pool=self._pool, graphed=self.graphed)
        return g

    def _step_graph(self, b: int, c: int, t: int, draft: bool = False) -> graphs.StepGraph:
        """A T-token step of tile ``(b, c)`` against its static cache, from
        static tokens ``[b, t]`` and lengths ``[b]``: the decode step (t=1,
        logits ``[b, V]``) or the verify step (t=K+1, ``[b, t, V]``), the
        target's or the draft's."""
        key = ("step", b, c, t, draft)
        if key in self._graphs:
            return self._graphs[key]
        inputs = {**self._cache_of(b, c, draft),
                  "tokens": torch.zeros((b, t), dtype=torch.int32, device=self.device),
                  "lengths": torch.zeros((b,), dtype=torch.int32, device=self.device)}
        decoder = self.draft_decoder if draft else self.decoder  # not self: see graphs.py

        def body():
            out = decoder(inputs["tokens"], inputs["lengths"], inputs)
            return out[:, 0] if t == 1 else out

        return self._graph(key, body, inputs)

    def _tile(self, bc: tuple[int, int]) -> graphs.StepGraph:
        """Decode tile ``bc``'s graph (a T=1 step; logits ``[b, V]``)."""
        return self._step_graph(*bc, 1)

    def _propose_graph(self, b: int, c: int, steps: int) -> graphs.StepGraph:
        """The greedy propose phase of a round as one graph: ``steps`` T=1
        draft steps against tile ``(b, c)``'s draft cache, step s feeding
        ``feed[:, s]`` while ``s <= lags`` (history the draft has not
        cached yet) and the previous step's argmax after it, at lengths
        ``lens0 + s``; returns the ``[steps, b]`` argmaxes (JAX's fused
        propose scan)."""
        key = ("propose", b, c, steps)
        if key in self._graphs:
            return self._graphs[key]
        z = functools.partial(torch.zeros, dtype=torch.int32, device=self.device)
        inputs = {**self._cache_of(b, c, True), "feed": z((b, steps)), "lags": z((b,)),
                  "lens0": z((b,))}
        decoder = self.draft_decoder

        def body():
            prev, outs = torch.zeros_like(inputs["lens0"]), []
            for s in range(steps):
                tok = torch.where(s <= inputs["lags"], inputs["feed"][:, s], prev)
                logits = decoder(tok[:, None], inputs["lens0"] + s, inputs)[:, 0]
                prev = logits.argmax(-1).to(torch.int32)
                outs.append(prev)
            return torch.stack(outs)

        return self._graph(key, body, inputs)

    def _page_graph(self, p: int, draft: bool = False) -> graphs.StepGraph:
        """A B=1 page graph of width ``p``: with chunked prefill, one
        ``CHUNK_PREFILL``-token chunk appended at offset ``lengths`` into a
        page of cache tile ``p`` (logits ``[1, W, V]``); otherwise the
        prompt tile ``p`` through the decoder against a page it fills from
        0 (logits ``[1, p, V]``). The page (``k``/``v``) is the graph's."""
        key = ("page", p, draft)
        if key in self._graphs:
            return self._graphs[key]
        w = self.chunk_prefill or p
        inputs = {**self._zero_cache(1, p, draft),
                  "tokens": torch.zeros((1, w), dtype=torch.int32, device=self.device),
                  "lengths": torch.zeros((1,), dtype=torch.int32, device=self.device)}
        decoder = self.draft_decoder if draft else self.decoder

        def body():
            return decoder(inputs["tokens"], inputs["lengths"], inputs)

        return self._graph(key, body, inputs)

    def _page_width(self, plen: int) -> int:
        """The page a ``plen``-token prompt fills: its prompt tile, or with
        chunked prefill the smallest cache tile holding its padded chunks."""
        if not self.chunk_prefill:
            return tile_for(self.prompt_tiles, plen)
        return tile_for(self.cache_tiles, -(-plen // self.chunk_prefill) * self.chunk_prefill)

    def _fill_page(self, ids: np.ndarray, draft: bool = False):
        """The prompt ``ids`` into a fresh page: ``(logits row of its last
        token [V], page, calls)``. The logits row is read before the next
        call of any graph."""
        plen, g = len(ids), self._page_graph(self._page_width(len(ids)), draft)
        w = self.chunk_prefill or g.inputs["tokens"].shape[1]  # one call of the whole tile
        n_calls = -(-plen // w)
        if self.chunk_prefill:
            for k in ("k", "v"):
                g.inputs[k].zero_()
        logits = None
        for i in range(n_calls):
            chunk = np.zeros((1, w), np.int32)
            seg = ids[i * w:(i + 1) * w]
            chunk[0, :len(seg)] = seg
            logits = g(tokens=torch.from_numpy(chunk),
                       lengths=torch.full((1,), i * w, dtype=torch.int32))
        return logits[0, (plen - 1) - (n_calls - 1) * w], g.inputs, n_calls

    def _decode(self, tokens: np.ndarray, lengths: np.ndarray):
        """One T=1 step of the live tile: logits [b, V] (head dtype), valid
        until the tile's next step."""
        g = self._tile((self._b_tile, self._c_tile))
        return g(tokens=torch.from_numpy(tokens[:, None]), lengths=torch.from_numpy(lengths))

    def _tile_work(self, meta_dec, b: int, c: int, t: int):
        """A ``t``-token step of tile ``(b, c)`` on the meta decoder (the
        ledger)."""
        m = self.model
        shape = (m.depth, b, m.num_heads, c, m.dim // m.num_heads)

        def work():
            cache = {n: torch.empty(shape, dtype=m.dtype, device="meta") for n in ("k", "v")}
            meta_dec(torch.empty((b, t), dtype=torch.int32, device="meta"),
                     torch.empty((b,), dtype=torch.int32, device="meta"), cache)

        return work

    def _count_tile(self, meta_dec, label: str, b: int, c: int, t: int, images: int) -> None:
        if meta_dec is not None:
            costmodel.capture_step(self._tile_work(meta_dec, b, c, t), label=label,
                                   phase="generate", images=images, device=self.device,
                                   arch=cfg.MODEL.ARCH)

    def _warm_up(self) -> None:
        try:
            k = self.spec_k
            z = functools.partial(torch.zeros, dtype=torch.int32)
            # the ledger of the decode and prompt (or chunk) tiles, as JAX's
            count = telemetry_spans.enabled() and cfg.TELEMETRY.COSTMODEL
            meta_dec = (GPTDecoder(costmodel.meta_copy(self.model), self.decoder.blk)
                        if count else None)
            for b, c in self._tiles:  # each graph's warm-up call and capture
                shapes = [(1, False)] + ([(k + 1, False), (1, True)] if k else [])
                for t, draft in shapes:
                    label = f"gen_decode_b{b}_c{c}" if (t, draft) == (1, False) else None
                    if label:
                        self._count_tile(meta_dec, label, b, c, 1, b)
                    g = self._step_graph(b, c, t, draft)
                    g(tokens=z((b, t)), lengths=z((b,)))
                    if label:
                        costmodel.capture_memory(g, label=label, phase="generate",
                                                 device=self.device)
                    self.n_compiles += 1
                    COMPILE_EVENTS.append(b)
                for steps in ((k, k + 1) if k else ()):
                    self._propose_graph(b, c, steps)(feed=z((b, steps)), lags=z((b,)),
                                                     lens0=z((b,)))
                    self.n_compiles += 1
                    COMPILE_EVENTS.append(b)
            for p in self.page_tiles:
                label = (f"gen_chunk_prefill_w{self.chunk_prefill}_c{p}" if self.chunk_prefill
                         else f"gen_prefill_p{p}")
                self._count_tile(meta_dec, label, 1, p, self.chunk_prefill or p, 1)
                for draft in ((False, True) if k else (False,)):
                    g = self._page_graph(p, draft)
                    g()
                    if not draft:
                        costmodel.capture_memory(g, label=label, phase="generate",
                                                 device=self.device)
                    self.n_compiles += 1
            for cache in self._caches.values():  # a fresh cache for the first requests
                for t in cache.values():
                    t.zero_()
            telemetry_registry.get_registry().counter("serve.aot_compiles").inc(self.n_compiles)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except BaseException as e:  # noqa: BLE001 — re-raised in __init__
            self._warm_error = e
        finally:
            self._warmed.set()

    # ------------------------------------------------------- client surface
    def start(self) -> "GenerateEngine":
        self._started = True
        self._go.set()
        return self

    def __enter__(self) -> "GenerateEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    def submit(self, prompt, max_new_tokens: int | None = None,
               sample: SampleParams | dict | None = None, trace=None) -> GenStream:
        """Enqueue one prompt (iterable of token ids); returns its token
        stream. Raises ``QueueFullError`` (``LongQueueFullError`` for a
        long prompt past the class's reservation) or ``EngineClosedError``
        like the image engine. ``sample`` overrides the engine's default
        :class:`SampleParams` for this request. ``trace`` (a
        ``tracectx.TraceContext`` or its ctrl-frame dict) makes the trace
        id the stream's ``request_id`` and turns on its spans; admission,
        scheduling and every token are the same without it."""
        if isinstance(trace, dict):
            trace = tracectx.from_fields(trace)
        sp = self._default_sample if sample is None else sample_params(sample)
        ids = np.asarray(list(prompt), np.int32)
        if ids.ndim != 1 or len(ids) < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        max_new = min(
            self.max_new,
            int(max_new_tokens) if max_new_tokens else self.max_new,
        )
        if self.chunk_prefill:
            # chunked prefill unpins the prompt bound from PROMPT_LEN: any
            # prompt the cache can hold next to its decode budget
            bound = self.cache_tiles[-1] - max_new - self.spec_k
            if len(ids) > bound:
                spec = f" + SPECULATE.K={self.spec_k}" if self.spec_k else ""
                raise ValueError(
                    f"prompt of {len(ids)} tokens cannot fit the cache: "
                    f"{len(ids)} + max_new={max_new}{spec} > largest "
                    f"GENERATE.CACHE_TILES entry {self.cache_tiles[-1]} — "
                    "chunked prefill admits any prompt the cache holds; "
                    "shorten the prompt, lower max_new_tokens, or raise "
                    "CACHE_TILES"
                )
        elif len(ids) > self.prompt_len:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds "
                f"GENERATE.PROMPT_LEN={self.prompt_len}"
            )
        if int(ids.max()) >= self.vocab_size or int(ids.min()) < 0:
            raise ValueError(
                f"prompt token ids must lie in [0, {self.vocab_size})"
            )
        lc = self._length_class(len(ids))
        with self._lock:
            try:
                self._admission.admit(
                    len(self._waiting), self._retry_after_ms(), length_class=lc,
                    class_depth=sum(1 for w in self._waiting
                                    if self._length_class(len(w[1])) == "long"))
            except QueueFullError:
                if lc == "long":
                    self._counters["long_rejected"] += 1
                raise
            stream = GenStream(self._next_id if trace is None else trace.trace_id, len(ids),
                               trace=trace)
            self._next_id += 1
            self._waiting.append((stream, ids, max_new, sp))
            self._counters["requests"] += 1
            if lc == "long":
                self._counters["long_admitted"] += 1
            self._lock.notify_all()
        return stream

    def _length_class(self, prompt_tokens: int) -> str:
        """"long" when classification is on and the prompt reaches
        ``long_prompt_threshold`` tokens; "short" otherwise."""
        return ("long" if self.long_threshold and prompt_tokens >= self.long_threshold
                else "short")

    def drain(self, timeout: float | None = 60.0) -> None:
        """Stop admitting, finish every queued and in-flight request, stop
        the scheduler. Idempotent."""
        with self._lock:
            self._draining = True
            self._admission.close()
            if not self._started:
                while self._waiting:
                    stream = self._waiting.popleft()[0]
                    stream._close(
                        "drained",
                        EngineClosedError("engine drained before start()"),
                    )
            self._lock.notify_all()
        self._go.set()
        self._thread.join(timeout)
        self._started = False

    def _retry_after_ms(self) -> float:
        ms = list(self._decode_ms)[-64:]
        per_tok = (sum(ms) / len(ms)) if ms else 10.0
        return max(50.0, per_tok * self.max_new / max(1, self.n_slots))

    def stats(self) -> dict:
        """The stats contract of the JAX engine (the fleet's warm-up gate
        reads ``buckets``/``n_compiles``, the router ``queue_depth``) plus
        the generation view."""
        with self._lock:
            waiting = len(self._waiting)
            waiting_long = sum(1 for w in self._waiting
                               if self._length_class(len(w[1])) == "long")
            active = sum(1 for s in self._slots if s is not None)
        dm = sorted(self._decode_ms)
        pm = sorted(self._prefill_ms)

        def pct(v, q):
            return round(v[min(len(v) - 1, int(q * len(v)))], 3) if v else 0.0

        el = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "queue_depth": waiting,
            "queue_depth_long": waiting_long,
            "long_threshold": self.long_threshold,
            "long_max_queue": self._admission.long_max_queue,
            "active": active,
            "slots": self.n_slots,
            "chunk_prefill": self.chunk_prefill,
            "n_compiles": self.n_compiles,
            "buckets": [list(t) for t in sorted(self._tiles)],
            "max_batch": self.n_slots,
            "batch_occupancy": active / max(1, self.n_slots),
            "decode_p50_ms": pct(dm, 0.50),
            "decode_p99_ms": pct(dm, 0.99),
            "prefill_p50_ms": pct(pm, 0.50),
            "prefill_p99_ms": pct(pm, 0.99),
            "tokens_per_s": round(self._counters["new_tokens"] / el, 2),
            **self._counters,
        }

    # ---------------------------------------------------------- scheduling
    def _free_slot(self) -> int | None:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _ensure_tile(self, b_need: int, c_need: int) -> None:
        """Grow the live caches (the target's and the draft's) to the
        smallest tile covering the need (zero padding at the end of the
        batch and cache dims; never a shrink mid-flight)."""
        b = tile_for(self.batch_tiles, max(b_need, self._b_tile))
        c = tile_for(self.cache_tiles, max(c_need, self._c_tile))
        if (b, c) == (self._b_tile, self._c_tile):
            return
        for draft in ((False, True) if self.spec_k else (False,)):
            old = self._draft_cache if draft else self._cache
            grown = self._cache_of(b, c, draft)  # the next tile's static cache
            for k in ("k", "v"):
                grown[k].zero_()
                grown[k][:, :old[k].shape[1], :, :old[k].shape[3]] = old[k]
            if draft:
                self._draft_cache = grown
            else:
                self._cache = grown
        self._b_tile, self._c_tile = b, c

    def _admit(self, stream: GenStream, ids: np.ndarray, max_new: int,
               sp: SampleParams) -> None:
        slot = self._free_slot()
        assert slot is not None
        t0 = time.perf_counter()
        plen = len(ids)
        width = self._page_width(plen)
        need = plen + max_new + self.spec_k
        # a chunked page sizes the tile too; a prompt tile must fit the
        # tile the request needs (JAX has no insert for a wider one)
        self._ensure_tile(slot + 1, max(need, width) if self.chunk_prefill else need)
        if width > self._c_tile:
            raise ValueError(
                f"prompt tile {width} does not fit the cache tile {self._c_tile}: "
                "raise GENERATE.CACHE_TILES"
            )
        row, page, calls = self._fill_page(ids)
        row = row.cpu().numpy()
        for k in ("k", "v"):
            self._cache[k][:, slot, :, :width] = page[k][:, 0]
        s = _Slot(stream, plen, 0, max_new, sp)
        first = self._select(s, row)
        s.last_token = first
        s.history = [int(t) for t in ids] + [first]
        self._slots[slot] = s
        if self.spec_k:  # the draft mirrors the prompt into its own paged cache
            _, dpage, dcalls = self._fill_page(ids, draft=True)
            for k in ("k", "v"):
                self._draft_cache[k][:, slot, :, :width] = dpage[k][:, 0]
            s.draft_len = plen
            calls += dcalls
        self._counters["prompt_tokens"] += plen
        if self.chunk_prefill:
            self._counters["chunk_prefills"] += 1
            self._counters["chunk_calls"] += calls
        ms = (time.perf_counter() - t0) * 1e3
        self._prefill_ms.append(ms)
        stream._emit(first)
        s.new_tokens = 1  # prefill produced token #1
        self._counters["new_tokens"] += 1
        if telemetry_spans.enabled():
            self._emit_admission(slot, stream, plen, width, sp, t0, ms)
        self._maybe_finish(slot, first)

    def _emit_admission(self, slot: int, stream: GenStream, plen: int, width: int,
                        sp: SampleParams, t0: float, ms: float) -> None:
        """An admission's records and trace spans."""
        telemetry_spans.emit_event("gen.admit", slot=slot, prompt_tokens=plen,
                                   request=stream.request_id,
                                   length_class=self._length_class(plen))
        if self.chunk_prefill:
            chunks = -(-plen // self.chunk_prefill)
            telemetry_spans.emit_event("gen.chunk_prefill", tokens=plen,
                                       chunk=self.chunk_prefill, chunks=chunks, tile=width,
                                       ms=round(ms, 3))
        else:
            telemetry_spans.emit_event("gen.prefill", tokens=plen, tile=width, ms=round(ms, 3))
        if not sp.greedy:
            telemetry_spans.emit_event("gen.sample", request=stream.request_id,
                                       temperature=sp.temperature, top_k=sp.top_k,
                                       top_p=sp.top_p, seed=sp.seed)
        tracectx.emit_trace_span(stream.trace, "queue_wait", stream.t_submit,
                                 t0 - stream.t_submit, parent=stream.span_id, slot=slot)
        if self.chunk_prefill:
            tracectx.emit_trace_span(stream.trace, "chunk_prefill", t0, ms / 1e3,
                                     parent=stream.span_id, tokens=plen,
                                     chunk=self.chunk_prefill, chunks=chunks, tile=width)
        else:
            tracectx.emit_trace_span(stream.trace, "prefill", t0, ms / 1e3,
                                     parent=stream.span_id, tokens=plen, tile=width)

    def _retire(self, slot: int, reason: str) -> None:
        s = self._slots[slot]
        self._slots[slot] = None
        self._counters["retired"] += 1
        s.stream._close(reason)
        if telemetry_spans.enabled():
            telemetry_spans.emit_event("gen.retire", slot=slot, new_tokens=s.new_tokens,
                                       reason=reason, request=s.stream.request_id)
            # the engine-side root of a traced request's tree: submit to retire
            tr = s.stream.trace
            tracectx.emit_trace_span(
                tr, "engine.request", s.stream.t_submit, time.perf_counter() - s.stream.t_submit,
                parent="" if tr is None else tr.parent_span, span_id=s.stream.span_id,
                reason=reason, new_tokens=s.new_tokens, prompt_tokens=s.stream.prompt_len,
                length_class=self._length_class(s.stream.prompt_len))

    def _maybe_finish(self, slot: int, token: int) -> bool:
        s = self._slots[slot]
        if token == self.eos_id:
            self._retire(slot, "eos")
            return True
        if s.new_tokens >= s.max_new:
            self._retire(slot, "max_new_tokens")
            return True
        if s.length + 1 >= self.cache_tiles[-1]:
            self._retire(slot, "cache_full")
            return True
        return False

    @staticmethod
    def _select(s: _Slot, row, stream: int = _U_PLAIN) -> int:
        """One token off one logit row for slot ``s``: greedy argmax draws
        nothing; sampled selection consumes the slot's next uniform."""
        if s.sample.greedy:
            return int(np.asarray(row).argmax())
        u = _uniform(s.sample.seed, stream, s.draws[stream])
        s.draws[stream] += 1
        return _pick(warp_probs(row, s.sample), u)

    def _emit_tok(self, i: int, tok: int) -> bool:
        s = self._slots[i]
        s.length += 1
        s.last_token = tok
        s.history.append(tok)
        s.new_tokens += 1
        self._counters["new_tokens"] += 1
        s.stream._emit(tok)
        return self._maybe_finish(i, tok)

    def _decode_step(self) -> None:
        t0 = time.perf_counter()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        # the traced residents now: a slot may retire below, but this
        # step's wall was its share
        traced = [(i, self._slots[i]) for i in live if self._slots[i].stream.trace is not None]
        c_need = max(self._slots[i].length for i in live) + 1
        self._ensure_tile(max(live) + 1, c_need)
        b = self._b_tile
        tokens = np.zeros((b,), np.int32)   # empty slots decode token 0 at length 0
        lengths = np.zeros((b,), np.int32)
        for i in live:
            tokens[i] = self._slots[i].last_token
            lengths[i] = self._slots[i].length
        logits = self._decode(tokens, lengths).cpu().numpy()  # the step's one sync
        ms = (time.perf_counter() - t0) * 1e3
        self._decode_ms.append(ms)
        self._counters["decode_steps"] += 1
        if telemetry_spans.enabled():
            # written before the tokens go out: a client that saw its last
            # token finds its step's record in the file
            telemetry_spans.emit_event("gen.decode", active=len(live), tile_b=b,
                                       tile_c=self._c_tile, ms=round(ms, 3))
            for i, s in traced:
                tracectx.emit_trace_span(s.stream.trace, "decode_step", t0, ms / 1e3,
                                         parent=s.stream.span_id, slot=i, tile_b=b,
                                         tile_c=self._c_tile, active=len(live))
        for i in live:
            self._emit_tok(i, self._select(self._slots[i], logits[i]))

    def _spec_propose_steps(self, live, props, qrows, steps, b, c) -> None:
        """The per-step propose path, for a round with a sampled slot: one
        draft decode call (and one sync) a step, proposals selected on the
        host in float64 (the replay contract)."""
        k = self.spec_k
        g = self._step_graph(b, c, 1, draft=True)
        for s_idx in range(steps):
            tokens = np.zeros((b, 1), np.int32)
            lengths = np.zeros((b,), np.int32)
            for i in live:
                sl = self._slots[i]
                pos = sl.draft_len + s_idx  # the position this step feeds
                tokens[i, 0] = (sl.history[pos] if pos <= sl.length
                                else props[i][pos - sl.length - 1])
                lengths[i] = pos
            dlogits = g(tokens=torch.from_numpy(tokens),
                        lengths=torch.from_numpy(lengths)).cpu().numpy()
            for i in live:
                sl = self._slots[i]
                if sl.draft_len + s_idx >= sl.length and len(props[i]) < k:
                    row = dlogits[i]
                    props[i].append(self._select(sl, row, _U_DRAFT))
                    if not sl.sample.greedy:
                        qrows.setdefault(i, []).append(row)

    def _spec_round(self) -> None:
        """One speculative round over every live slot (JAX's ``_spec_round``).

        1. Propose: K draft proposals a slot (greedy: the draft's argmax;
           sampled: drawn from the warped draft distribution). A slot whose
           draft cache trails by one position (its previous round accepted
           every proposal) first feeds that history token, and the round
           runs one more step so every slot proposes K.
        2. Verify: one T=K+1 target call over ``[last, d_1..d_K]``.
        3. Accept, left to right: greedy keeps d_j while it is the target's
           argmax and emits the target's argmax where it is not; sampled
           keeps d_j iff ``u·q(d_j) <= p(d_j)`` and resamples a rejection
           from ``max(p − q, 0)``. All K kept: a bonus token off the
           (K+1)-th row.
        """
        t0 = time.perf_counter()
        k = self.spec_k
        live = [i for i, s in enumerate(self._slots) if s is not None]
        traced = [(i, self._slots[i]) for i in live if self._slots[i].stream.trace is not None]
        max_len = max(self._slots[i].length for i in live)
        self._ensure_tile(max(live) + 1, max_len + k + 1)
        b, c = self._b_tile, self._c_tile

        props: dict[int, list[int]] = {i: [] for i in live}
        qrows: dict[int, list[np.ndarray]] = {}
        steps = k + max(self._slots[i].length - self._slots[i].draft_len for i in live)
        if all(self._slots[i].sample.greedy for i in live) and steps in (k, k + 1):
            # proposal j of a slot with lag L is the argmax of step L + j
            feed = np.zeros((b, steps), np.int32)
            lags = np.zeros((b,), np.int32)
            lens0 = np.zeros((b,), np.int32)
            for i in live:
                sl = self._slots[i]
                lag = sl.length - sl.draft_len
                lags[i], lens0[i] = lag, sl.draft_len
                feed[i, :lag + 1] = sl.history[sl.draft_len:sl.draft_len + lag + 1]
            outs = self._propose_graph(b, c, steps)(
                feed=torch.from_numpy(feed), lags=torch.from_numpy(lags),
                lens0=torch.from_numpy(lens0)).cpu().numpy()
            for i in live:
                lag = int(lags[i])
                props[i] = [int(outs[s, i]) for s in range(lag, lag + k)]
        else:
            self._spec_propose_steps(live, props, qrows, steps, b, c)

        tokens = np.zeros((b, k + 1), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i in live:
            sl = self._slots[i]
            tokens[i, 0] = sl.last_token
            tokens[i, 1:] = props[i]
            lengths[i] = sl.length
        vlogits = self._step_graph(b, c, k + 1)(
            tokens=torch.from_numpy(tokens), lengths=torch.from_numpy(lengths)).cpu().numpy()

        n_acc = n_bonus = n_rej = 0
        for i in live:
            sl = self._slots[i]
            old_draft_len = sl.draft_len
            for j in range(k):
                d = int(props[i][j])
                trow = vlogits[i, j]
                if sl.sample.greedy:
                    tgt = int(trow.argmax())
                    if d == tgt:
                        n_acc += 1
                        if self._emit_tok(i, d):
                            break
                        continue
                    # the corrective token is the target's argmax: what
                    # target-only greedy decode emits here
                    n_rej += 1
                    self._emit_tok(i, tgt)
                    break
                p = warp_probs(trow, sl.sample)
                q = warp_probs(qrows[i][j], sl.sample)
                u = _uniform(sl.sample.seed, _U_ACCEPT, sl.draws[_U_ACCEPT])
                sl.draws[_U_ACCEPT] += 1
                if u * q[d] <= p[d]:
                    n_acc += 1
                    if self._emit_tok(i, d):
                        break
                    continue
                n_rej += 1
                r = np.maximum(p - q, 0.0)  # rejected: resample the residual
                if r.sum() <= 0.0:
                    r = p
                u = _uniform(sl.sample.seed, _U_RESID, sl.draws[_U_RESID])
                sl.draws[_U_RESID] += 1
                self._emit_tok(i, _pick(r, u))
                break
            else:
                n_bonus += 1  # every proposal kept, the slot still live
                self._emit_tok(i, self._select(sl, vlogits[i, k]))
            if self._slots[i] is not None:
                # the draft's cache is valid through the last kept position,
                # capped by what this round's steps wrote
                sl.draft_len = min(old_draft_len + steps, sl.length)

        ms = (time.perf_counter() - t0) * 1e3
        self._decode_ms.append(ms)
        self._counters["decode_steps"] += 1
        self._counters["spec_rounds"] += 1
        self._counters["spec_proposed"] += k * len(live)
        self._counters["spec_accepted"] += n_acc
        self._counters["spec_bonus"] += n_bonus
        self._counters["spec_rejected"] += n_rej
        if telemetry_spans.enabled():
            telemetry_spans.emit_event("gen.speculate", k=k, active=len(live),
                                       proposed=k * len(live), accepted=n_acc, bonus=n_bonus,
                                       ms=round(ms, 3))
            for i, s in traced:
                tracectx.emit_trace_span(s.stream.trace, "spec_round", t0, ms / 1e3,
                                         parent=s.stream.span_id, slot=i, k=k,
                                         accepted=n_acc, bonus=n_bonus, active=len(live))

    def _emit_token_counters(self) -> None:
        """The running token counters as one ``lm.tokens`` record."""
        if telemetry_spans.enabled():
            telemetry_spans.emit_event(
                "lm.tokens", prompt_tokens=self._counters["prompt_tokens"],
                new_tokens=self._counters["new_tokens"],
                decode_steps=self._counters["decode_steps"],
                elapsed_s=round(time.perf_counter() - self._t0, 3))

    def _scheduler(self) -> None:
        # inference mode is thread-local: enter it in the thread that runs
        # the forwards
        with torch.inference_mode():
            self._warm_up()
            if self._warm_error is not None:
                return
            self._go.wait()
            last_emit = time.perf_counter()
            while True:
                with self._lock:
                    # continuous batching: admit into free slots at every
                    # step boundary
                    while self._waiting and self._free_slot() is not None:
                        stream, ids, max_new, sp = self._waiting.popleft()
                        try:
                            self._admit(stream, ids, max_new, sp)
                        except Exception as e:  # noqa: BLE001 — fail ONE request
                            stream._close("error", e)
                    active = any(s is not None for s in self._slots)
                    if not active:
                        if self._draining and not self._waiting:
                            break
                        self._lock.wait(timeout=self._poll_s)
                        continue
                # the step runs outside the lock: ``submit`` (the serving
                # threads) enqueues or refuses while the card decodes, instead
                # of waiting for a gap between steps; only this thread touches
                # the slots
                try:
                    if self.spec_k:
                        self._spec_round()
                    else:
                        self._decode_step()
                except Exception as e:  # noqa: BLE001 — a device fault fails
                    # every in-flight request loudly; new ones are still served
                    for i, s in enumerate(self._slots):
                        if s is not None:
                            self._slots[i] = None
                            s.stream._close("error", e)
                if time.perf_counter() - last_emit >= EMIT_INTERVAL_S:
                    self._emit_token_counters()
                    last_emit = time.perf_counter()
            self._emit_token_counters()
