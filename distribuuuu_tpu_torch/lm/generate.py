"""KV-cache generation with continuous batching (counterpart of
distribuuuu_tpu/lm/generate.py, without chunked prefill, speculative or
tensor-parallel decode).

**Prefill/decode split.** A prompt runs once through the decoder against
an empty cache (whole prompt, padded to a power-of-two prompt tile); that
gives its K/V and the first generated token. Every later token is a
decode step: one token per sequence against the cached K/V.

**Paged per-request KV cache** ``{"k", "v"}: [L, B, H, C, D]`` in the
compute dtype, one page (row) per request slot: admitting a request
overwrites its page, retiring frees the slot without moving data. Where
the JAX package returns a new cache from each step, the port writes the
cache in place (one cache in device memory, no copy a step).

**(batch, cache-len) tiles, one graph each.** A step runs the smallest
tile covering the live slots and the longest sequence; crossing a tile
boundary copies the live rows into the next tile's cache once. The JAX
engine compiles every tile ahead of time; the port captures every decode
tile and every prompt tile as one CUDA graph (``graphs.StepGraph``: a
warm-up call, then the capture, on the engine's own memory pool), in the
scheduler thread, before it serves (PyTorch keeps cuBLAS handles per
thread). Each decode tile owns its static cache, tokens and lengths, each
prompt tile its static page and tokens; a step copies its inputs in and
replays. On the CPU the same bodies run eagerly on the same buffers.
``n_compiles`` counts the tiles captured (warmed, on the CPU).

**The decode step's attention.** ``CachedAttention`` applies the GPT's own
``blocks.N.attn`` modules (there is no second copy of the parameters).
At T = 1, when ``decode_attn.supported`` holds for the cache tile, the
step goes through ``ops/cuda/decode_attn.decode_attention`` (the kernel on
the card); otherwise, and for every prefill, it runs the dense fp32
region, as the JAX package does.

**Continuous batching.** The scheduler admits and retires per decode
step; tokens stream to each requester the step they are produced
(:class:`GenStream`).

**Sampling** is host numpy, the JAX package's functions verbatim, so a
seed replays the same stream in both.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from distribuuuu_tpu_torch import graphs, not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.ops.cuda import decode_attn
from distribuuuu_tpu_torch.serve.admission import AdmissionController, EngineClosedError
from distribuuuu_tpu_torch.serve.engine import COMPILE_EVENTS

LM_PLANE = "LM plane"


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
    JAX package's; the port validates, then refuses chunked prefill)."""
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
# however requests were batched.

_U_PLAIN = 0


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


# -------------------------------------------------------------- the engine


class GenStream:
    """Per-request streamed result: iterate for tokens as they decode, or
    ``result()`` for the full list. Closed exactly once at retire."""

    def __init__(self, request_id, prompt_len: int):
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.t_submit = time.perf_counter()
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
        while True:
            with self._cond:
                while not self._q and not self._done:
                    self._cond.wait(timeout=0.1)
                if self._q:
                    yield self._q.popleft()
                    continue
                if self._error is not None:
                    raise self._error
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
                 "sample", "draws")

    def __init__(self, stream, length, last_token, max_new, sample):
        self.stream = stream
        self.length = length          # cached positions (prompt + generated-1)
        self.last_token = last_token  # feeds the next decode step
        self.new_tokens = 0
        self.max_new = max_new
        self.sample = sample          # SampleParams for this request
        self.draws = [0, 0, 0, 0]     # per-stream uniform draw counters


class GenerateEngine:
    """Continuous-batching generation of a GPT on one device.

    ``model`` is a ``models/gpt.GPT``; it is moved to ``device``, put in
    eval and prepared (compute-dtype weights cast once) here. Every decode
    and prefill tile runs once in the scheduler thread during
    construction; ``start()`` lets it serve; ``submit`` returns a
    :class:`GenStream`. Refused, with their ROADMAP item: chunked prefill,
    a draft model (speculative decoding) and the long-prompt admission
    class."""

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
            raise not_ported(f"GENERATE.CHUNK_PREFILL={self.chunk_prefill} (chunked "
                             "paged prefill)", LM_PLANE)
        if draft_model is not None:
            raise not_ported("a draft model (GENERATE.SPECULATE, speculative decoding)",
                             LM_PLANE)
        self.long_threshold = int(
            long_prompt_threshold if long_prompt_threshold is not None
            else cfg.SERVE.LONG_PROMPT_THRESHOLD
        )
        long_q = int(long_max_queue if long_max_queue is not None else cfg.SERVE.LONG_MAX_QUEUE)
        if self.long_threshold or long_q:
            raise not_ported(
                f"length-aware admission (SERVE.LONG_PROMPT_THRESHOLD={self.long_threshold}, "
                f"SERVE.LONG_MAX_QUEUE={long_q})", LM_PLANE)
        self._default_sample = sample_params(sample)
        self.prompt_tiles = default_tiles(self.prompt_len)
        self.n_slots = self.batch_tiles[-1]
        self._admission = AdmissionController(
            max_queue if max_queue is not None else cfg.SERVE.MAX_QUEUE
        )

        if self.device.type == "cuda" and model.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        self.model = model.to(self.device).eval().prepare()
        self.decoder = decoder_for(self.model)
        self._dtype = model.dtype
        self._heads = model.num_heads
        self._head_dim = model.dim // model.num_heads
        self._depth = model.depth
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
        self._decode_graphs: dict = {}  # (b, c) -> StepGraph over the tile's buffers
        self._prefill_graphs: dict = {}  # prompt tile -> StepGraph over its page
        self._cache = self._tile((self._b_tile, self._c_tile)).inputs
        self._draining = False
        self._started = False
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._counters = {
            "prompt_tokens": 0, "new_tokens": 0, "decode_steps": 0,
            "requests": 0, "retired": 0,
        }
        self._decode_ms: deque = deque(maxlen=4096)
        self._prefill_ms: deque = deque(maxlen=1024)

        # -- warm every tile once, in the thread that serves -----------------
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
    def _zero_cache(self, b: int, c: int) -> dict:
        shape = (self._depth, b, self._heads, c, self._head_dim)
        return {k: torch.zeros(shape, dtype=self._dtype, device=self.device)
                for k in ("k", "v")}

    def _tile(self, bc: tuple[int, int]) -> graphs.StepGraph:
        """Decode tile ``(b, c)``'s graph: a T=1 step of its static tokens
        ``[b, 1]`` and lengths ``[b]`` against its static cache (the
        inputs ``k``/``v``); returns logits ``[b, V]``."""
        g = self._decode_graphs.get(bc)
        if g is None:
            b, c = bc
            inputs = {**self._zero_cache(b, c),
                      "tokens": torch.zeros((b, 1), dtype=torch.int32, device=self.device),
                      "lengths": torch.zeros((b,), dtype=torch.int32, device=self.device)}
            decoder = self.decoder  # not self: the graph is freed with the engine

            def body():
                return decoder(inputs["tokens"], inputs["lengths"], inputs)[:, 0]

            g = self._decode_graphs[bc] = graphs.StepGraph(body, inputs, device=self.device,
                                                           pool=self._pool, graphed=self.graphed)
        return g

    def _prompt_tile(self, p: int) -> graphs.StepGraph:
        """Prompt tile ``p``'s graph: the tile through the decoder against
        its static page (``k``/``v`` of ``[L, 1, H, p, D]``, every row of
        which the prefill writes); returns logits ``[1, p, V]``."""
        g = self._prefill_graphs.get(p)
        if g is None:
            inputs = {**self._zero_cache(1, p),
                      "tokens": torch.zeros((1, p), dtype=torch.int32, device=self.device)}
            lengths = torch.zeros((1,), dtype=torch.int32, device=self.device)
            decoder = self.decoder

            def body():
                return decoder(inputs["tokens"], lengths, inputs)

            g = self._prefill_graphs[p] = graphs.StepGraph(body, inputs, device=self.device,
                                                           pool=self._pool, graphed=self.graphed)
        return g

    def _prefill(self, padded: np.ndarray):
        """The prompt tile through the decoder against its page: (logits
        [1, P, V], the page). Both are the graph's static buffers, valid
        until the next prefill."""
        g = self._prompt_tile(padded.shape[1])
        return g(tokens=torch.from_numpy(padded)), g.inputs

    def _decode(self, tokens: np.ndarray, lengths: np.ndarray):
        """One T=1 step of the live tile: logits [b, V] (head dtype), valid
        until the tile's next step."""
        g = self._tile((self._b_tile, self._c_tile))
        return g(tokens=torch.from_numpy(tokens[:, None]), lengths=torch.from_numpy(lengths))

    def _warm_up(self) -> None:
        try:
            for bc in self._tiles:  # each tile's warm-up call and capture
                b = bc[0]
                self._tile(bc)(tokens=torch.zeros((b, 1), dtype=torch.int32),
                               lengths=torch.zeros((b,), dtype=torch.int32))
                self.n_compiles += 1
                COMPILE_EVENTS.append(b)
            for p in self.prompt_tiles:
                self._prefill(np.zeros((1, p), np.int32))
                self.n_compiles += 1
            for g in self._decode_graphs.values():  # a fresh cache for the first requests
                for k in ("k", "v"):
                    g.inputs[k].zero_()
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
               sample: SampleParams | dict | None = None) -> GenStream:
        """Enqueue one prompt (iterable of token ids); returns its token
        stream. Raises ``QueueFullError``/``EngineClosedError`` like the
        image engine. ``sample`` overrides the engine's default
        :class:`SampleParams` for this request."""
        sp = self._default_sample if sample is None else sample_params(sample)
        ids = np.asarray(list(prompt), np.int32)
        if ids.ndim != 1 or len(ids) < 1:
            raise ValueError("prompt must be a non-empty 1-D token list")
        max_new = min(
            self.max_new,
            int(max_new_tokens) if max_new_tokens else self.max_new,
        )
        if len(ids) > self.prompt_len:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds "
                f"GENERATE.PROMPT_LEN={self.prompt_len}"
            )
        if int(ids.max()) >= self.vocab_size or int(ids.min()) < 0:
            raise ValueError(
                f"prompt token ids must lie in [0, {self.vocab_size})"
            )
        with self._lock:
            self._admission.admit(len(self._waiting), self._retry_after_ms())
            stream = GenStream(self._next_id, len(ids))
            self._next_id += 1
            self._waiting.append((stream, ids, max_new, sp))
            self._counters["requests"] += 1
            self._lock.notify_all()
        return stream

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
            active = sum(1 for s in self._slots if s is not None)
        dm = sorted(self._decode_ms)
        pm = sorted(self._prefill_ms)

        def pct(v, q):
            return round(v[min(len(v) - 1, int(q * len(v)))], 3) if v else 0.0

        el = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "queue_depth": waiting,
            "queue_depth_long": 0,
            "long_threshold": self.long_threshold,
            "long_max_queue": 0,
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
        """Grow the live cache to the smallest tile covering the need
        (zero padding at the end of the batch and cache dims; never a
        shrink mid-flight)."""
        b = tile_for(self.batch_tiles, max(b_need, self._b_tile))
        c = tile_for(self.cache_tiles, max(c_need, self._c_tile))
        if (b, c) == (self._b_tile, self._c_tile):
            return
        grown = self._tile((b, c)).inputs  # the next tile's static cache
        for k in ("k", "v"):
            old = self._cache[k]
            grown[k].zero_()
            grown[k][:, :old.shape[1], :, :old.shape[3]] = old
        self._cache = grown
        self._b_tile, self._c_tile = b, c

    def _admit(self, stream: GenStream, ids: np.ndarray, max_new: int,
               sp: SampleParams) -> None:
        slot = self._free_slot()
        assert slot is not None
        t0 = time.perf_counter()
        plen = len(ids)
        ptile = tile_for(self.prompt_tiles, plen)
        self._ensure_tile(slot + 1, plen + max_new)
        if ptile > self._c_tile:
            raise ValueError(
                f"prompt tile {ptile} does not fit the cache tile {self._c_tile}: "
                "raise GENERATE.CACHE_TILES"
            )
        padded = np.zeros((1, ptile), np.int32)
        padded[0, :plen] = ids
        logits, page = self._prefill(padded)
        for k in ("k", "v"):
            self._cache[k][:, slot, :, :ptile] = page[k][:, 0]
        s = _Slot(stream, plen, 0, max_new, sp)
        first = self._select(s, logits[0, plen - 1].cpu().numpy())
        s.last_token = first
        self._slots[slot] = s
        self._counters["prompt_tokens"] += plen
        self._prefill_ms.append((time.perf_counter() - t0) * 1e3)
        stream._emit(first)
        s.new_tokens = 1  # prefill produced token #1
        self._counters["new_tokens"] += 1
        self._maybe_finish(slot, first)

    def _retire(self, slot: int, reason: str) -> None:
        s = self._slots[slot]
        self._slots[slot] = None
        self._counters["retired"] += 1
        s.stream._close(reason)

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
        s.new_tokens += 1
        self._counters["new_tokens"] += 1
        s.stream._emit(tok)
        return self._maybe_finish(i, tok)

    def _decode_step(self) -> None:
        t0 = time.perf_counter()
        live = [i for i, s in enumerate(self._slots) if s is not None]
        c_need = max(self._slots[i].length for i in live) + 1
        self._ensure_tile(max(live) + 1, c_need)
        b = self._b_tile
        tokens = np.zeros((b,), np.int32)   # empty slots decode token 0 at length 0
        lengths = np.zeros((b,), np.int32)
        for i in live:
            tokens[i] = self._slots[i].last_token
            lengths[i] = self._slots[i].length
        logits = self._decode(tokens, lengths).cpu().numpy()  # the step's one sync
        self._decode_ms.append((time.perf_counter() - t0) * 1e3)
        self._counters["decode_steps"] += 1
        for i in live:
            self._emit_tok(i, self._select(self._slots[i], logits[i]))

    def _scheduler(self) -> None:
        # inference mode is thread-local: enter it in the thread that runs
        # the forwards
        with torch.inference_mode():
            self._warm_up()
            if self._warm_error is not None:
                return
            self._go.wait()
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
                    try:
                        self._decode_step()
                    except Exception as e:  # noqa: BLE001 — a device fault fails
                        # every in-flight request loudly; new ones are still served
                        for i, s in enumerate(self._slots):
                            if s is not None:
                                self._slots[i] = None
                                s.stream._close("error", e)
