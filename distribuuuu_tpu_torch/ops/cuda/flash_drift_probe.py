"""Probes of the CPU f32 flash Function's drift on the card host (the
plain versions behind ``flash_attention_with_lse``), for the card test
``tests/test_torch_cuda.py::test_flash_gradients_on_card_match_the_cpu``.

* As a pytest plugin, it reruns the CPU Function after every test and
  compares its bits with the session's first run; each drift is written
  to ``FLASH_DRIFT_OUT`` (default ``flash_drift.jsonl``) as a JSON line
  with the process's arithmetic state, a second call's bits, the call
  with oneDNN off and a call half a second later::

      python -m pytest --noconftest -m cuda tests/test_torch_cuda.py \\
          -p distribuuuu_tpu_torch.ops.cuda.flash_drift_probe

* As a script, it runs the test's pattern (the Function on the card, then
  on the CPU) ``--loops`` times, against CPU-only loops, and prints the
  drifts it finds::

      python -m distribuuuu_tpu_torch.ops.cuda.flash_drift_probe --loops 400

* ``--first-calls N`` starts N fresh interpreters, each running the plain
  forward's first steps twice (a batched matmul, its row max, then
  ``torch.exp``) and reporting whether the first ``exp`` gave the second's
  bits, and how many elements and how far it differed from f64. It runs
  on the CPU alone::

      python -m distribuuuu_tpu_torch.ops.cuda.flash_drift_probe --first-calls 300
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

SHAPE = (2, 3, 97, 40)  # the card test's inputs: a head dim the kernels pad


def _inputs():
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(5)]
    return arrs, rng.standard_normal(SHAPE[:3]).astype(np.float32)


def run(device, causal: bool = False, mkldnn: bool = True) -> list[torch.Tensor]:
    """``(o, lse, dq, dk, dv)`` of the card test on ``device``, on the CPU."""
    from distribuuuu_tpu_torch.ops.cuda import flash_attention as fa

    arrs, g_lse = _inputs()
    off = torch.backends.mkldnn.flags(enabled=False) if not mkldnn else contextlib.nullcontext()
    with off:
        q, k, v = (torch.tensor(a, device=device, requires_grad=True) for a in arrs[:3])
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        loss = (o * torch.tensor(arrs[3], device=device)).sum() + \
            (lse * torch.tensor(g_lse, device=device)).sum()
        return [t.detach().cpu() for t in (o, lse, *torch.autograd.grad(loss, (q, k, v)))]


def errors(got, want) -> list[float]:
    """Max |got − want| over max(max |want|, 1), output by output."""
    return [float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1.0)
            for a, b in zip(got, want)]


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def state() -> dict:
    """What could change the CPU's f32 arithmetic, and the live threads."""
    s = {"threads": torch.get_num_threads(), "interop": torch.get_num_interop_threads(),
         "float32_matmul_precision": torch.get_float32_matmul_precision(),
         "mkldnn": torch.backends.mkldnn.enabled,
         "py_threads": [t.name for t in threading.enumerate()]}
    for name in ("fp32_precision", "matmul.fp32_precision", "conv.fp32_precision"):
        node = torch.backends.mkldnn
        for part in name.split("."):
            node = getattr(node, part, None)
        s[f"mkldnn.{name}"] = node
    return s


_ref: dict[bool, list[torch.Tensor]] = {}


def pytest_sessionstart(session):
    for causal in (False, True):
        _ref[causal] = run(torch.device("cpu"), causal)


def pytest_runtest_teardown(item, nextitem):
    cpu = torch.device("cpu")
    for causal in (False, True):
        got = run(cpu, causal)
        if same(got, _ref[causal]):
            continue
        again, no_mkldnn = run(cpu, causal), run(cpu, causal, mkldnn=False)
        time.sleep(0.5)
        later = run(cpu, causal)
        rec = {"after": item.nodeid, "causal": causal, "state": state(),
               "err_vs_first": errors(got, _ref[causal]),
               "again_is_first": same(again, _ref[causal]),
               "no_mkldnn_err": errors(no_mkldnn, _ref[causal]),
               "later_err": errors(later, _ref[causal])}
        with open(os.environ.get("FLASH_DRIFT_OUT", "flash_drift.jsonl"), "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")


_FIRST_CALL = """
import json, numpy as np, torch
rng = np.random.default_rng(3)
q, k = (torch.tensor(rng.standard_normal((6, 97, 40)).astype(np.float32)) for _ in range(2))
def f():
    s = (q @ k[:, :64].transpose(1, 2)) * (40 ** -0.5)
    return torch.exp(s - s.amax(-1, keepdim=True)), s - s.amax(-1, keepdim=True)
(a, x), (b, _) = f(), f()
ex = torch.exp(x.double())
d = (a != b).flatten().nonzero()[:, 0]
print(json.dumps({"threads": torch.get_num_threads(), "differ": len(d),
                  "first": int(d[0]) if len(d) else None,
                  "first_err": float(((a.double() - ex) / ex).abs().max()),
                  "second_err": float(((b.double() - ex) / ex).abs().max())}))
"""


def first_calls(n: int) -> int:
    """Run :data:`_FIRST_CALL` in ``n`` fresh interpreters; print each
    drift and the count."""
    import subprocess
    import sys

    drifts = 0
    for _ in range(n):
        out = subprocess.run([sys.executable, "-c", _FIRST_CALL], capture_output=True,
                             text=True, check=True, timeout=120).stdout
        rec = json.loads(out.strip().splitlines()[-1])
        if rec["differ"]:
            drifts += 1
            print(json.dumps(rec), flush=True)
    print(json.dumps({"processes": n, "first_call_drifts": drifts}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loops", type=int, default=400)
    ap.add_argument("--first-calls", type=int, default=0)
    args = ap.parse_args(argv)
    if args.first_calls:
        return first_calls(args.first_calls)
    if not torch.cuda.is_available():
        raise SystemExit("flash_drift_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    ref = run(cpu)
    for mode in ("card_then_cpu", "cpu_only", "card_sync_then_cpu"):
        drifts, t0 = 0, time.perf_counter()
        for i in range(args.loops):
            if mode != "cpu_only":
                run(dev)
                if mode == "card_sync_then_cpu":
                    torch.cuda.synchronize()
                    time.sleep(0.002)
            got = run(cpu)
            if not same(got, ref):
                drifts += 1
                print(json.dumps({"mode": mode, "i": i, "err": errors(got, ref),
                                  "again_is_first": same(run(cpu), ref)}), flush=True)
        print(json.dumps({"mode": mode, "loops": args.loops, "drifts": drifts,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
