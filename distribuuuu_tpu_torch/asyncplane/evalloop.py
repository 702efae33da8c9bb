"""Concurrent eval: ``trainer.validate`` overlapped with the next train epoch
(counterpart of distribuuuu_tpu/asyncplane/evalloop.py).

At an epoch boundary the trainer takes a snapshot of the model on its
device (:func:`device_snapshot`: a separate module instance, parameters
and buffers cloned, no optimizer state) and hands it to a worker thread
that runs the real ``trainer.validate``; the result joins at the next
boundary, where the main thread logs it and does the best bookkeeping.
The snapshot is a module of its own, so the live model's ``train()``
never drops its eval weight cache and the live model is never served by
it.

On the card the worker runs on its own CUDA stream, made once in the
first worker thread and kept for the later ones. The stream waits on an
event recorded on the launching thread's stream after the snapshot
copies, so eval reads finished copies while training goes on on its own
stream; each worker synchronises its stream before it ends, and the
snapshot and its batches are held until the join. The conv-epilogue
kernel keys its split-K workspace by stream, so eval has its own. Only
this worker launches ``conv1x1_bn_act`` while it runs (training runs
the unfused path), so that kernel's launch count stays exact.

With several processes eval's final sum runs on its own process group
(``trainer.validate``'s ``group``), which every rank creates at start-up
in the same order: two threads never interleave collectives on one
communicator, which is what the JAX package's dispatch sequencer and
cross-host ring exist for.

Eval is a pure read of its snapshot: the training trajectory is bitwise
the same with the feature on or off, and so are the eval metrics.
"""

from __future__ import annotations

import copy
import threading

import torch


def device_snapshot(model: torch.nn.Module) -> torch.nn.Module:
    """A separate instance of ``model`` on its device, every parameter and
    buffer cloned, in eval mode, holding no gradient."""
    snap = copy.deepcopy(model)
    for p in snap.parameters():
        p.requires_grad_(False)
    return snap.eval()


class ConcurrentEval:
    """One in-flight eval at a time. ``eval_fn(snapshot, epoch)`` is the
    trainer's ``validate`` closure; :meth:`launch` takes the snapshot
    before it returns; :meth:`join` blocks for the result and re-raises a
    worker failure."""

    def __init__(self, eval_fn):
        self._eval_fn = eval_fn
        self._thread: threading.Thread | None = None
        self._stream = None
        self._epoch = self._snap = self._result = None
        self._error: BaseException | None = None

    @property
    def in_flight(self) -> bool:
        return self._thread is not None

    def launch(self, model: torch.nn.Module, epoch: int) -> None:
        """Snapshot ``model`` and start the worker on it."""
        if self._thread is not None:
            raise RuntimeError("ConcurrentEval.launch with an eval still in flight: join() "
                               "the previous epoch's result first")
        snap = device_snapshot(model)
        device = next(snap.parameters()).device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        self._epoch, self._snap, self._result, self._error = int(epoch), snap, None, None

        def _work():
            try:
                if ready is None:
                    self._result = self._eval_fn(snap, self._epoch)
                    return
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device)
                self._stream.wait_event(ready)
                with torch.cuda.device(device), torch.cuda.stream(self._stream):
                    self._result = self._eval_fn(snap, self._epoch)
                self._stream.synchronize()
            except BaseException as e:  # re-raised by join
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True,
                                        name="dtpu-concurrent-eval")
        self._thread.start()

    def join(self):
        """Block for the in-flight eval: ``(epoch, result, snapshot)``, or
        None when none is in flight."""
        if self._thread is None:
            return None
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._snap = None
            raise err
        out = self._epoch, self._result, self._snap
        self._epoch = self._snap = self._result = None
        return out
