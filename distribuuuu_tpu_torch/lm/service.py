"""Replica-side LM generation service (counterpart of
distribuuuu_tpu/lm/service.py, without tensor-parallel decoding and
without trace spans).

``serve_net`` builds this engine instead of the image engine when
``MODEL.ARCH`` is a ``gpt_*`` arch: the same length-prefixed socket and
the same ``stats`` control frame, plus the streaming generate frames:

  request:   ctrl ``op="generate"`` ``{"tokens": [...]}`` or
             ``{"text": "..."}`` (byte-tokenized server-side), optional
             ``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``,
             ``seed``
  response:  ``{"stream": "token", "token": t, "i": k}`` per decoded
             token, then ``{"stream": "done", "tokens": [...], "text":
             "...", "reason": ...}`` (or one ``{"error": ...}`` frame;
             backpressure keeps the image engine's retry-after shape).
"""

from __future__ import annotations

import json
import socket

import torch

from distribuuuu_tpu_torch import not_ported
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.lm.generate import GenerateEngine
from distribuuuu_tpu_torch.lm.tokenizer import ByteTokenizer
from distribuuuu_tpu_torch.serve import protocol
from distribuuuu_tpu_torch.serve.admission import EngineClosedError, QueueFullError


def engine_from_cfg(graphed: bool | None = None) -> GenerateEngine:
    """The generation engine from the global cfg: the configured gpt_*
    arch on ``cuda:{SERVE.DEVICE}`` (the CPU only under ``DEVICE.PLATFORM
    cpu``), weights from ``MODEL.WEIGHTS`` (a torch ``.pth``) or made from
    ``RNG_SEED``, GENERATE.* tiles warmed; ``graphed`` as
    :class:`GenerateEngine`'s. ``GENERATE.SPECULATE.ENABLED`` also builds
    the ``DRAFT_ARCH`` draft (:func:`_draft_from_cfg`), and every decode
    step becomes a speculative round."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.utils import weights

    if not cfg.MODEL.ARCH.startswith("gpt"):
        raise ValueError(
            f"lm.service serves the gpt_* archs, got {cfg.MODEL.ARCH!r} — "
            "image archs serve through serve/engine.py"
        )
    if int(cfg.MESH.MODEL) > 1:
        raise not_ported(f"tensor-parallel decode (MESH.MODEL={cfg.MESH.MODEL})",
                         "Parallel layouts beyond DP")
    kwargs = _draft_from_cfg() if cfg.GENERATE.SPECULATE.ENABLED else {}
    device = trainer.device_from_cfg()
    model = trainer.build_model_from_cfg()
    if cfg.MODEL.WEIGHTS:
        weights.load_weights(model, cfg.MODEL.WEIGHTS)
    elif cfg.MODEL.PRETRAINED:
        raise weights.pretrained_refusal(cfg.MODEL.ARCH)
    return GenerateEngine(model, device=device, graphed=graphed, **kwargs)


def _draft_from_cfg() -> dict:
    """The draft half of a speculative engine from ``GENERATE.SPECULATE``:
    the ``DRAFT_ARCH`` model, made from ``RNG_SEED`` like the target (so
    ``DRAFT_ARCH`` = ``MODEL.ARCH`` drafts with the target's own weights)
    or loaded from ``DRAFT_WEIGHTS`` (a ``.pth``), after the
    tokenizer-identity check: speculation verifies the draft's token ids
    under the target's distribution."""
    from distribuuuu_tpu_torch.models import build_model
    from distribuuuu_tpu_torch.models.layers import resolve_dtype
    from distribuuuu_tpu_torch.utils import weights

    arch = cfg.GENERATE.SPECULATE.DRAFT_ARCH
    if not arch.startswith("gpt"):
        raise ValueError(
            f"GENERATE.SPECULATE.DRAFT_ARCH={arch!r} is not a gpt_* zoo "
            "arch — the draft decodes through the same GPTDecoder"
        )
    # every gpt_* arch tokenizes with the one byte tokenizer, so the
    # fingerprints coincide; the check is what a second tokenizer would trip
    t_id, d_id = ByteTokenizer().identity(), ByteTokenizer().identity()
    if t_id != d_id:
        raise ValueError(
            f"GENERATE.SPECULATE.DRAFT_ARCH={arch}: draft tokenizer "
            f"identity {d_id} != target tokenizer identity {t_id} — "
            "draft proposals are token ids; accept/reject is undefined "
            "across tokenizers"
        )
    draft = build_model(arch, num_classes=cfg.MODEL.NUM_CLASSES,
                        dtype=resolve_dtype(cfg.DEVICE.COMPUTE_DTYPE),
                        seq_len=int(cfg.LM.SEQ_LEN),
                        generator=torch.Generator().manual_seed(int(cfg.RNG_SEED or 0)))
    if cfg.GENERATE.SPECULATE.DRAFT_WEIGHTS:
        weights.load_weights(draft, cfg.GENERATE.SPECULATE.DRAFT_WEIGHTS)
    return {"draft_model": draft, "spec_k": int(cfg.GENERATE.SPECULATE.K)}


def handle_generate(engine: GenerateEngine, ctrl: dict, send) -> None:
    """Serve one ``op="generate"`` ctrl request: submit, then one frame per
    token and a final done frame through ``send(payload_bytes)``. The
    optional ``temperature``/``top_k``/``top_p``/``seed`` fields override
    the replica's ``GENERATE.SAMPLE`` defaults for this request."""
    tok = ByteTokenizer()
    if "tokens" in ctrl:
        ids = [int(t) for t in ctrl["tokens"]]
    elif "text" in ctrl:
        ids = [int(t) for t in tok.encode(ctrl["text"])]
    else:
        send(json.dumps({"error": "generate needs 'tokens' or 'text'"}).encode())
        return
    sample = {k: ctrl[k] for k in ("temperature", "top_k", "top_p", "seed") if k in ctrl}
    try:
        stream = engine.submit(ids, ctrl.get("max_new_tokens"), sample=sample or None)
    except QueueFullError as e:
        send(json.dumps({
            "error": "queue_full",
            "retry_after_ms": round(e.retry_after_ms, 1),
        }).encode())
        return
    except EngineClosedError:
        send(json.dumps({"error": "draining"}).encode())
        return
    except ValueError as e:
        send(json.dumps({"error": f"ValueError: {e}"}).encode())
        return
    out = []
    try:
        for token in stream:
            out.append(token)
            send(json.dumps({"stream": "token", "token": token, "i": len(out) - 1}).encode())
    except Exception as e:  # noqa: BLE001 — fail THIS request only
        send(json.dumps({"stream": "done", "error": f"{type(e).__name__}: {e}",
                         "tokens": out, "n": len(out)}).encode())
        return
    send(json.dumps({
        "stream": "done",
        "tokens": out,
        "n": len(out),
        "text": tok.decode(out),
        "reason": stream.reason,
    }).encode())


def generate_request(host: str, port: int, *, tokens=None, text=None,
                     max_new_tokens: int | None = None,
                     temperature: float | None = None,
                     top_k: int | None = None, top_p: float | None = None,
                     seed: int | None = None, timeout: float = 60.0):
    """Client helper: send one generate request to a replica and yield the
    decoded frames, token frames as they stream and the done frame last.
    Raises on an error frame. A request that sets the sampling fields
    replays verbatim (same frame, same stream)."""
    fields = {}
    if tokens is not None:
        fields["tokens"] = [int(t) for t in tokens]
    if text is not None:
        fields["text"] = text
    if max_new_tokens is not None:
        fields["max_new_tokens"] = int(max_new_tokens)
    if temperature is not None:
        fields["temperature"] = float(temperature)
    if top_k is not None:
        fields["top_k"] = int(top_k)
    if top_p is not None:
        fields["top_p"] = float(top_p)
    if seed is not None:
        fields["seed"] = int(seed)
    with socket.create_connection((host, port), timeout=timeout) as conn:
        conn.settimeout(timeout)
        protocol.send_frame(conn, protocol.ctrl_request("generate", **fields))
        while True:
            payload = protocol.recv_frame(conn)
            if payload is None:
                raise ConnectionResetError("peer closed mid-generation (no done frame)")
            frame = json.loads(payload)
            if "error" in frame and "stream" not in frame:
                raise RuntimeError(f"generate failed: {frame}")
            yield frame
            if frame.get("stream") == "done":
                return
