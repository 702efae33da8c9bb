"""Dynamic micro-batching inference engine (counterpart of
distribuuuu_tpu/serve/engine.py), in the order requests meet it:

1. **Admission** (``admission.AdmissionController``): ``submit`` rejects
   beyond ``SERVE.MAX_QUEUE`` pending requests with a retry-after hint.
2. **Dynamic micro-batching**: a batcher thread takes up to
   ``SERVE.MAX_BATCH`` requests, or flushes ``SERVE.MAX_WAIT_MS`` after the
   oldest waiting request arrived.
3. **Bucketed shapes, one graph each**: a batch of n pads (zero rows) to
   the smallest bucket ≥ n. Every bucket's normalize and forward is
   captured at startup as one CUDA graph over a static device input
   (``graphs.StepGraph``: a warm-up call, where cuDNN picks its
   algorithms, then the capture, on the engine's own memory pool), the
   counterpart of the JAX engine's AOT compile; ``n_compiles`` counts the
   buckets captured (on the CPU, warmed: the body runs eagerly there) and
   steady-state serving never adds to it.
4. **Double-buffered dispatch**: the batch is staged in a pinned host
   buffer, copied into the bucket's static input asynchronously, and the
   graph replays; its logits are copied out of the pool on the stream
   (the next replay overwrites them); the batcher hands the in-flight
   logits to a completion thread through a depth-2 queue and assembles
   the next batch while the card works.
5. **Per-request futures**: the completer's ``.cpu()`` is the
   synchronisation point; it slices off the padding rows and resolves
   request i's ``Future`` with row i.

The forward is the model's eval forward. The fp32 master weights are cast
to the compute dtype once, here (``model.prepare()``), not per forward.
Under ``SERVE.QUANTIZE`` (``bf16`` or ``int8``, ``serve/quantize.py``) the
engine keeps only the packed weights on the card; every bucket's graph
dequantizes them and runs ``prepare()`` at its head, every replay, as the
JAX engine dequantizes inside its compiled forward. ``memory`` holds the
engine's ``torch.cuda.memory_allocated`` after warm-up and its graphs'
pool bytes, to compare a quantized engine's footprint with full
precision's.

Telemetry: the warm-up's captures add to the registry's
``serve.aot_compiles`` (and, as every capture, to ``jit.compiles``); each
bucket's ledger (``serve_bucket_{b}``, ``serve_bucket_{b}_{mode}`` when
quantized: the forward counted on the meta device, and the graph's
first-call memory) lands before it serves; a quantized engine emits one
``kind="serve.quantized"`` record (JAX's byte meta); the completer writes
a ``kind="serve"`` snapshot every ``EMIT_INTERVAL_S`` and one at shutdown.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Queue

import numpy as np
import torch

from distribuuuu_tpu_torch import graphs
from distribuuuu_tpu_torch.config import cfg
from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.serve.admission import (
    AdmissionController,
    EngineClosedError,
)
from distribuuuu_tpu_torch.serve.metrics import ServeMetrics
from distribuuuu_tpu_torch.telemetry import costmodel
from distribuuuu_tpu_torch.telemetry import registry as telemetry_registry
from distribuuuu_tpu_torch.telemetry import spans as telemetry_spans

# Warm-up hook: every bucket warmed at startup appends its batch size.
# Steady-state serving must not grow this list.
COMPILE_EVENTS: list[int] = []
EMIT_INTERVAL_S = 10.0  # seconds between the serve records (the LM's lm.tokens too)


def default_buckets(max_batch: int) -> list[int]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be ≥ 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class _Request:
    __slots__ = ("image", "future", "t_enq")

    def __init__(self, image: np.ndarray, t_enq: float):
        self.image = image
        self.future: Future = Future()
        self.t_enq = t_enq


class _Stage:
    """A host staging buffer for one bucket (pinned for a CUDA device) and
    the event that marks its host-to-device copy done."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
        self.copied = torch.cuda.Event() if cuda else None


class Engine:
    """Request-level serving engine over one device.

    ``model`` is an eval-mode ``nn.Module`` on NHWC input (the port's
    ResNet or ViT); it is moved to ``device`` and prepared here. Parameters default
    from ``cfg.SERVE``. ``submit`` before ``start`` is allowed — requests
    queue until the threads run.
    """

    def __init__(
        self,
        model,
        im_size: int,
        *,
        device,
        max_batch: int | None = None,
        max_wait_ms: float | None = None,
        bucket_sizes: list[int] | None = None,
        max_queue: int | None = None,
        input_dtype=np.uint8,
        graphed: bool | None = None,
        quantize: str | None = None,
    ):
        self.quantize_mode = str((cfg.SERVE.QUANTIZE if quantize is None else quantize) or "")
        self.quantize_meta = None
        self.device = torch.device(device)
        self.im_size = int(im_size)
        self.max_batch = int(max_batch if max_batch is not None else cfg.SERVE.MAX_BATCH)
        wait = max_wait_ms if max_wait_ms is not None else cfg.SERVE.MAX_WAIT_MS
        self._max_wait_s = float(wait) / 1e3
        buckets = bucket_sizes or list(cfg.SERVE.BUCKET_SIZES) or default_buckets(
            self.max_batch
        )
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1 or self.buckets[-1] != self.max_batch:
            raise ValueError(
                f"SERVE.BUCKET_SIZES {self.buckets} must lie in [1, MAX_BATCH] "
                f"and include MAX_BATCH={self.max_batch} (a batch of n pads "
                "to the smallest bucket ≥ n; larger buckets would be dead "
                "warmed shapes)"
            )
        self.input_dtype = np.dtype(input_dtype)
        self.metrics = ServeMetrics()
        self._admission = AdmissionController(
            max_queue if max_queue is not None else cfg.SERVE.MAX_QUEUE
        )

        if self.device.type == "cuda" and model.dtype == torch.float32:
            # fp32 means fp32: cuDNN convs would otherwise run TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        model.eval()
        count = telemetry_spans.enabled() and cfg.TELEMETRY.COSTMODEL
        self._meta = costmodel.meta_copy(model.prepare()) if count else None
        model.eval()  # a mode change drops the host caches prepare() made for the copy
        self._packed = None
        if self.quantize_mode:
            from distribuuuu_tpu_torch.serve import quantize as quantize_lib

            packed, self.quantize_meta = quantize_lib.quantize_state(model, self.quantize_mode)
            self._packed = quantize_lib.Packed(model, packed, self.device)
            telemetry_spans.emit_event(
                "serve.quantized", arch=cfg.MODEL.ARCH, mode=self.quantize_mode,
                **{k: self.quantize_meta[k] for k in ("bytes_before", "bytes_after", "leaves",
                                                       "quantized_leaves")})
            self.model = model.to(self.device)
        else:
            self.model = model.to(self.device).prepare()
        self.memory: dict = {}

        # two staging buffers per bucket: the batcher fills one while the
        # other's copy may still be in flight
        tdtype = torch.from_numpy(np.zeros(0, self.input_dtype)).dtype
        shape = (self.im_size, self.im_size, 3)
        self._stages = {
            b: [_Stage((b, *shape), tdtype, self.device) for _ in range(2)]
            for b in self.buckets
        }
        self._turn = dict.fromkeys(self.buckets, 0)
        self._graphs: dict[int, graphs.StepGraph] = {}  # made in the batcher thread
        # on the card every bucket is a graph; graphed=False runs the
        # bodies eagerly (only to measure the graphs against them)
        self.graphed = graphs.graphed(self.device) if graphed is None else graphed
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

        self._cond = threading.Condition()
        self._pending: deque[_Request] = deque()
        # depth-2 in-flight queue = the double buffer
        self._inflight: Queue = Queue(maxsize=2)
        self._draining = False
        self._started = False
        self._go = threading.Event()
        self._completer_t = threading.Thread(
            target=self._completer, name="serve-completer", daemon=True
        )

        # -- warm every bucket shape once, at startup ----------------------
        # in the batcher thread, which runs every later forward: PyTorch
        # keeps the cuDNN algorithm cache and the cuBLAS handles per thread
        self.n_compiles = 0
        self._warm_error: BaseException | None = None
        self._warmed = threading.Event()
        self._batcher_t = threading.Thread(
            target=self._batcher, name="serve-batcher", daemon=True
        )
        self._batcher_t.start()
        self._warmed.wait()
        if self._warm_error is not None:
            raise self._warm_error

    # -- model forward -------------------------------------------------------
    def _graph(self, bucket: int) -> graphs.StepGraph:
        """The bucket's graph: normalize (uint8 input) and forward over its
        static device input."""
        g = self._graphs.get(bucket)
        if g is None:
            stage = self._stages[bucket][0].host
            x = torch.empty(stage.shape, dtype=stage.dtype, device=self.device)
            model, packed = self.model, self._packed  # not self: freed with the engine

            def body():
                if packed is not None:  # dequant and prepare(), in the graph
                    packed.bind()
                return model(normalize_on_device(x) if x.dtype == torch.uint8 else x)

            g = self._graphs[bucket] = graphs.StepGraph(body, {"x": x}, device=self.device,
                                                        pool=self._pool, graphed=self.graphed)
        return g

    def _run(self, bucket: int, images: list[np.ndarray]) -> torch.Tensor:
        """Stage ``images`` (zero rows pad to ``bucket``), copy them into
        the bucket's static input, and run its graph. Returns the logits on
        the device, copied out of the graph's pool, without waiting for
        them."""
        stage = self._stages[bucket][self._turn[bucket]]
        self._turn[bucket] ^= 1
        if stage.copied is not None:
            stage.copied.synchronize()  # its previous copy has left the buffer
        host = stage.host.numpy()
        for i, img in enumerate(images):
            host[i] = img
        host[len(images):] = 0
        g = self._graph(bucket)
        g.inputs["x"].copy_(stage.host, non_blocking=True)
        if stage.copied is not None:
            stage.copied.record(torch.cuda.current_stream(self.device))
        out = g()
        return out.clone() if g.graphed else out

    # -- client surface ----------------------------------------------------
    def start(self) -> "Engine":
        self._completer_t.start()
        self._started = True
        self._go.set()
        return self

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one request; returns a Future resolving to its logits
        row. Raises ``QueueFullError`` (backpressure) or
        ``EngineClosedError`` (draining) instead of queueing unboundedly."""
        image = np.asarray(image)
        want = (self.im_size, self.im_size, 3)
        if image.shape != want or image.dtype != self.input_dtype:
            raise ValueError(
                f"request image must be {want} {self.input_dtype.name} "
                f"(the engine's input), got {image.shape} {image.dtype.name}"
            )
        with self._cond:
            self._admission.admit(len(self._pending), self._retry_after_ms())
            req = _Request(image, time.perf_counter())
            self._pending.append(req)
            self._cond.notify()
        return req.future

    def drain(self, timeout: float | None = 60.0) -> None:
        """Graceful shutdown: stop accepting, finish every queued and
        in-flight request, stop the threads. Idempotent."""
        with self._cond:
            self._draining = True
            self._admission.close()
            if not self._started:
                # never started: nothing will ever serve the queue
                while self._pending:
                    self._pending.popleft().future.set_exception(
                        EngineClosedError("engine drained before start()")
                    )
            self._cond.notify_all()
        self._go.set()
        self._batcher_t.join(timeout)
        if self._started:
            self._completer_t.join(timeout)

    def stats(self) -> dict:
        with self._cond:
            depth = len(self._pending)
        out = self.metrics.snapshot()
        out.update(
            queue_depth=depth,
            n_compiles=self.n_compiles,
            buckets=list(self.buckets),
            max_batch=self.max_batch,
            quantize=self.quantize_mode,
        )
        return out

    def _retry_after_ms(self) -> float:
        """Queue depth × recent service time per slot, floored at the
        batching window."""
        per_slot = self.metrics.mean_batch_ms() / self.max_batch
        with_depth = self._admission.max_queue * per_slot / 2
        return max(self._max_wait_s * 1e3, with_depth)

    # -- batcher thread ----------------------------------------------------
    def _collect(self) -> list[_Request] | None:
        """Block until MAX_BATCH are waiting, MAX_WAIT_MS passed since the
        oldest arrived, or draining. None = drained dry."""
        with self._cond:
            while not self._pending and not self._draining:
                self._cond.wait(timeout=0.1)
            if not self._pending:
                return None
            deadline = self._pending[0].t_enq + self._max_wait_s
            while len(self._pending) < self.max_batch and not self._draining:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            take = min(len(self._pending), self.max_batch)
            return [self._pending.popleft() for _ in range(take)]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise AssertionError(f"no bucket for batch {n}")  # unreachable

    def _bucket_work(self, meta, b: int):
        """Bucket ``b``'s forward on the meta copy ``meta`` (the ledger)."""
        stage = self._stages[b][0].host
        x = torch.empty(stage.shape, dtype=stage.dtype, device="meta")
        return lambda: meta(normalize_on_device(x) if x.dtype == torch.uint8 else x)

    def _warm_up(self) -> None:
        try:
            meta, mode = self._meta, self.quantize_mode
            for b in self.buckets:  # each bucket's warm-up call and capture
                label = f"serve_bucket_{b}_{mode}" if mode else f"serve_bucket_{b}"
                if meta is not None:
                    costmodel.capture_step(self._bucket_work(meta, b), label=label,
                                           phase="serve", images=b, device=self.device,
                                           arch=cfg.MODEL.ARCH)
                self._run(b, [])
                costmodel.capture_memory(self._graphs[b], label=label, phase="serve",
                                         device=self.device)
                self.n_compiles += 1
                COMPILE_EVENTS.append(b)
            telemetry_registry.get_registry().counter("serve.aot_compiles").inc(self.n_compiles)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.memory = {
                    "allocated_bytes": torch.cuda.memory_allocated(self.device),
                    "pool_bytes": graphs.pool_bytes(self._pool) if self._pool else 0,
                    "packed_bytes": self._packed.resident_bytes if self._packed else 0,
                }
        except BaseException as e:  # noqa: BLE001 — re-raised in __init__
            self._warm_error = e
        finally:
            self._warmed.set()

    def _batcher(self) -> None:
        # inference mode is thread-local: enter it in the thread that runs
        # the forwards
        with torch.inference_mode():
            self._warm_up()
            if self._warm_error is not None:
                return
            self._go.wait()
            while True:
                reqs = self._collect()
                if reqs is None:
                    break
                bucket = self._bucket_for(len(reqs))
                try:
                    out = self._run(bucket, [r.image for r in reqs])
                except Exception as e:  # noqa: BLE001 — fail THIS batch only
                    for r in reqs:
                        r.future.set_exception(e)
                    continue
                self._inflight.put((out, reqs, bucket, time.perf_counter()))
        self._inflight.put(None)  # completer shutdown sentinel

    # -- completion thread -------------------------------------------------
    def _completer(self) -> None:
        last_emit = time.perf_counter()
        while True:
            item = self._inflight.get()
            if item is None:
                self.metrics.emit(final=True)  # a no-op without a jsonlog sink
                break
            out, reqs, bucket, t_disp = item
            try:
                logits = out.cpu().numpy()  # waits for the device
            except Exception as e:  # noqa: BLE001 — a fault surfaces here
                for r in reqs:
                    r.future.set_exception(e)
                continue
            t_done = time.perf_counter()
            lats = []
            for i, r in enumerate(reqs):
                r.future.set_result(np.array(logits[i]))
                lats.append(t_done - r.t_enq)
            self.metrics.record_batch(len(reqs), bucket, t_done - t_disp, lats)
            if t_done - last_emit >= EMIT_INTERVAL_S:
                self.metrics.emit()  # a no-op without a jsonlog sink
                last_emit = t_done


def engine_from_cfg(graphed: bool | None = None) -> Engine:
    """Build a serving Engine from the global cfg: the configured arch on
    ``cuda:{SERVE.DEVICE}`` (or the CPU under ``DEVICE.PLATFORM cpu``),
    weights from ``MODEL.WEIGHTS`` (a torch ``.pth`` or an orbax
    directory) or made from ``RNG_SEED``, input dtype per
    ``DATA.DEVICE_NORMALIZE``, packed per ``SERVE.QUANTIZE``; ``graphed``
    as :class:`Engine`'s."""
    from distribuuuu_tpu_torch import trainer
    from distribuuuu_tpu_torch.utils import weights

    from distribuuuu_tpu_torch.serve.quantize import MODES

    if cfg.SERVE.QUANTIZE and cfg.SERVE.QUANTIZE not in MODES:
        raise ValueError(f"SERVE.QUANTIZE must be one of {MODES} (or empty), "
                         f"got {cfg.SERVE.QUANTIZE!r}")
    device = trainer.device_from_cfg()
    model = trainer.build_model_from_cfg()
    if cfg.MODEL.WEIGHTS:
        weights.load_weights(model, cfg.MODEL.WEIGHTS)
    elif cfg.MODEL.PRETRAINED:
        raise weights.pretrained_refusal(cfg.MODEL.ARCH)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
        torch.backends.cudnn.deterministic = bool(
            cfg.CUDNN.DETERMINISTIC or cfg.DEVICE.DETERMINISTIC
        )
    return Engine(
        model,
        cfg.TRAIN.IM_SIZE,
        device=device,
        input_dtype=np.uint8 if cfg.DATA.DEVICE_NORMALIZE else np.float32,
        graphed=graphed,
        quantize=str(cfg.SERVE.QUANTIZE or ""),
    )
