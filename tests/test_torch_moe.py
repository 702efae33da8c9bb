"""The port's ``ops/moe.py`` against the JAX package's ``ops/moe.py``, and
its expert-parallel strategies on 2 and 4 gloo CPU ranks
(``tests/torch_tp_worker.py``) against its own dense reference.

Tolerances. Where both sides compute in f64 (the expert FFNs, the
combine, top-k and the balancing statistics given the same router
probabilities) they agree to 1e-12. The router itself is f32 in both
packages whatever the input dtype (JAX ``ops/moe.py:72`` casts to f32), and
XLA's and PyTorch's f32 matmul and exp differ in the last ulp, so a routed
output agrees with JAX's to ~1e-7 of its scale: those comparisons assert
the top-k indices identical first, then hold values at 1e-6 relative. The
port's sharded strategies and its reference run the same router on the
same inputs, so they agree to 1e-12, gradients included, except the
gate's gradient under dispatch: each rank's f32 router backward covers its
own tokens and the shares are summed, so it agrees to 1e-6 relative (a
missing or doubled share is an error of order 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_port_util import Ranks, few_threads

from distribuuuu_tpu.ops import moe as jmoe
from distribuuuu_tpu_torch.ops import moe as tmoe

D, HID, E, K = 16, 24, 8, 2
T = 40  # tokens: not a multiple of 3, so the 4-rank dispatch pads
ROUTED = 1e-6  # relative, the f32 router's ulps (module docstring)
EXACT = 1e-12


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _params(seed: int = 0, tie: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    gate = rng.standard_normal((D, E)) / np.sqrt(D)
    if tie:  # experts 2 and 5 tie in every row, and lead where x[:, -1] is large
        gate[-1] = 0.0
        gate[-1, 2] = 2.0
        gate[:, 5] = gate[:, 2]
    return {"gate": gate,
            "w_in": rng.standard_normal((E, D, HID)) / np.sqrt(D),
            "b_in": 0.1 * rng.standard_normal((E, HID)),
            "w_out": rng.standard_normal((E, HID, D)) / np.sqrt(HID),
            "b_out": 0.1 * rng.standard_normal((E, D))}


def _x(seed: int = 1, n: int = T) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D))


def _t(tree) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of the scale > {rtol}"


def test_expert_ffn_at_f64(x64):
    p, x = _params(), _x()
    want = jmoe._expert_ffn(*(jnp.asarray(p[k][3]) for k in tmoe.EXPERT_KEYS),
                            jnp.asarray(x))
    got = tmoe._expert_ffn(*(torch.from_numpy(p[k][3]) for k in tmoe.EXPERT_KEYS),
                           torch.from_numpy(x))
    _close(got, want, EXACT, "expert ffn")


def test_top_k_balance_and_aux_from_the_same_probs(x64):
    logits = _x() @ _params()["gate"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jw, ji = jmoe.top_k_from_probs(jnp.asarray(probs), K)
    tw, ti = tmoe.top_k_from_probs(torch.from_numpy(probs), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, EXACT, "top-k weights")
    jf, jp = jmoe.balance_stats(jnp.asarray(probs), K)
    tf, tp_ = tmoe.balance_stats(torch.from_numpy(probs), K)
    _close(tf, jf, EXACT, "f")
    _close(tp_, jp, EXACT, "p")
    assert float(tf.sum()) == pytest.approx(1.0, abs=1e-15)
    _close(tmoe.load_balancing_loss_from_probs(torch.from_numpy(probs), K),
           jmoe.load_balancing_loss_from_probs(jnp.asarray(probs), K), EXACT, "aux")


def test_top_k_ties_take_the_lower_expert_first(x64):
    """Two identical gate columns tie in every row, in both packages:
    ``jax.lax.top_k`` gives the lower index first, and so must the port
    (``torch.topk`` promises no order among equal values)."""
    p, x = _params(tie=True), _x()
    x[::2, -1] = 3.0
    jw, ji = jmoe.top_k_gating(jnp.asarray(x), jnp.asarray(p["gate"]), K)
    tw, ti = tmoe.top_k_gating(torch.from_numpy(x), torch.from_numpy(p["gate"]), K)
    ji, ti = np.asarray(ji), ti.numpy()
    both = (ji == 2).any(-1) & (ji == 5).any(-1)
    assert both.sum() >= T // 2  # rows where the tied pair is the top 2
    assert (ji[both] == [2, 5]).all()
    np.testing.assert_array_equal(ti, ji)
    _close(tw, jw, ROUTED, "tied weights")
    # a probability row of exact ties: 0 before 1 before 2, the rest after
    probs = np.array([[0.25, 0.25, 0.25, 0.125, 0.125]])
    np.testing.assert_array_equal(tmoe.top_k_from_probs(torch.from_numpy(probs), 3)[1],
                                  np.asarray(jmoe.top_k_from_probs(jnp.asarray(probs), 3)[1]))


def test_router_and_reference_against_jax(x64):
    """The router in f32 agrees to its ulps; given JAX's own routing, the
    port's combine of every expert reproduces ``moe_ffn_reference`` at
    f64; with its own routing (the same indices) to the router's ulps."""
    p, x = _params(), _x()
    jprobs = jmoe.gating_probs(jnp.asarray(x), jnp.asarray(p["gate"]))
    tprobs = tmoe.gating_probs(torch.from_numpy(x), torch.from_numpy(p["gate"]))
    assert tprobs.dtype == torch.float32 and jprobs.dtype == jnp.float32
    _close(tprobs, jprobs, ROUTED, "router")
    want = jmoe.moe_ffn_reference(_j(p), jnp.asarray(x), top_k=K)
    jw, ji = jmoe.top_k_gating(jnp.asarray(x), jnp.asarray(p["gate"]), K)
    tw, ti = tmoe.top_k_gating(torch.from_numpy(x), torch.from_numpy(p["gate"]), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    given = tmoe._weighted_experts(_t(p), torch.from_numpy(x), torch.from_numpy(np.array(jw)),
                                   torch.from_numpy(np.array(ji)), 0)
    _close(given, want, EXACT, "combine given JAX's routing")
    _close(tmoe.moe_ffn_reference(_t(p), torch.from_numpy(x), K), want, ROUTED, "reference")


def _reference_grads(p: dict, x: np.ndarray, dy: np.ndarray):
    params = {k: v.clone().requires_grad_(True) for k, v in _t(p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmoe.moe_ffn_reference(params, xt, K)
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach(), {"x": xt.grad, **{k: v.grad for k, v in params.items()}}


def _jax_runs(p: dict, x: np.ndarray, dy: np.ndarray, n: int, runs) -> dict:
    """JAX's batched strategies on an n-device CPU mesh (data 1, the
    expert axis ``model`` n): outputs, dropped fractions and the gradients
    of ``Σ out · dy``."""
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    xb, dyb = jnp.asarray(x)[None], jnp.asarray(dy)[None]
    out = {}
    for name, impl, cf in runs:
        def loss(params, xx, impl=impl, cf=cf):
            if impl == "partial":
                y = jmoe.moe_ffn_partial_batched(params, xx, mesh=mesh, axis="model", top_k=K)
                return jnp.sum(y * dyb), (y, jnp.float64(0.0))
            y, dropped = jmoe.moe_ffn_dispatch_batched(params, xx, mesh=mesh, axis="model",
                                                       top_k=K, capacity_factor=cf)
            return jnp.sum(y * dyb), (y, dropped)

        (_, (y, dropped)), (gp, gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(_j(p), xb)
        out[name] = {"out": np.asarray(y[0]), "dropped": float(dropped),
                     "grads": {"x": np.asarray(gx[0]), **{k: np.asarray(v) for k, v in gp.items()}}}
    return out


RUNS = [["partial", "partial", 0.0], ["dispatch", "dispatch", 8.0],
        ["tight", "dispatch", 0.5]]


@pytest.mark.parametrize("n", [2, 4])
def test_partial_and_dispatch_on_ranks(tmp_path, x64, n):
    """The expert-parallel strategies on ``n`` gloo ranks: partial and
    dispatch at an ample capacity equal the dense reference at f64, their
    outputs and the gradients of the gate, the input and each rank's
    experts (the sum's identity backward and the entered input and gate
    pinned: a wrong one scales or drops a share); at a tight capacity the
    dropped fraction is JAX's exactly and the output and gradients JAX's
    to the router's ulps."""
    p, x = _params(seed=n), _x(seed=10 + n)
    dy = np.random.default_rng(20 + n).standard_normal(x.shape)
    data = tmp_path / "data.pt"
    torch.save({"params": _t(p), "x": torch.from_numpy(x), "dy": torch.from_numpy(dy)}, data)
    ranks = Ranks(n, [{"name": "ops", "kind": "moe_ops", "data": str(data), "top_k": K,
                       "runs": RUNS}], tmp_path, f"moe{n}")
    want_out, want_g = _reference_grads(p, x, dy)
    jax_runs = _jax_runs(p, x, dy, n, RUNS)
    outs = [r["ops"] for r in ranks.join()]
    local = E // n
    for name, _, _ in RUNS:
        got = [o[name] for o in outs]
        for r in range(1, n):  # the output and the replicated grads agree on every rank
            for key in ("out",):
                assert torch.equal(got[r][key], got[0][key]), (name, key)
            for key in ("x", "gate"):
                assert torch.equal(got[r]["grads"][key], got[0]["grads"][key]), (name, key)
        full = {k: torch.cat([g["grads"][k] for g in got]) for k in tmoe.EXPERT_KEYS}
        grads = {"x": got[0]["grads"]["x"], "gate": got[0]["grads"]["gate"], **full}
        jr = jax_runs[name]
        _close(got[0]["out"], jr["out"], ROUTED, f"{name} out vs JAX")
        for k, g in grads.items():
            _close(g, jr["grads"][k], ROUTED, f"{name} d{k} vs JAX")
        if name == "tight":
            assert got[0]["dropped"] > 0.05
            assert got[0]["dropped"] == pytest.approx(jr["dropped"], abs=1e-15)
            continue
        if name == "dispatch":
            assert got[0]["dropped"] == 0.0 == jr["dropped"]
        _close(got[0]["out"], want_out, EXACT, f"{name} out")
        for k, g in grads.items():
            # dispatch's gate gradient is each rank's f32 router backward
            # over its own tokens, summed: f32 sums in another order
            routed = name == "dispatch" and k == "gate"
            _close(g, want_g[k], ROUTED if routed else EXACT, f"{name} d{k}")
        for r in range(n):
            assert got[r]["grads"]["w_in"].shape[0] == local


def test_capacity_and_dispatch_slots_on_one_rank():
    """One rank (a group of one, no collective): C is JAX's formula; the
    slot order drops the later (token, k) assignments of a full expert."""
    assert tmoe.capacity(40, 4, 2, 8, 2.0) == 5
    assert tmoe.capacity(3, 4, 2, 8, 0.1) == 1
    from distribuuuu_tpu_torch.parallel import tp

    p, x = _t(_params()), torch.from_numpy(_x())
    one = tp.Shard(None, 0, 1)
    out, dropped = tmoe.moe_ffn_dispatch(p, x, one, K, 64.0)
    assert float(dropped) == 0.0
    _close(out, tmoe.moe_ffn_reference(p, x, K), EXACT, "ample dispatch on one rank")
    out, dropped = tmoe.moe_ffn_dispatch(p, x, one, K, 0.25)
    _, idx = tmoe.top_k_gating(x, p["gate"], K)
    cap = tmoe.capacity(T, 1, K, E, 0.25)
    seen, kept = {}, 0
    for e in idx.reshape(-1).tolist():
        seen[e] = seen.get(e, 0) + 1
        kept += seen[e] <= cap
    assert float(dropped) == pytest.approx(1.0 - kept / (T * K), abs=1e-7)
