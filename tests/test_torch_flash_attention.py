"""The port's flash attention (distribuuuu_tpu_torch/ops/cuda/flash_attention.py)
and single-device attention (ops/ring_attention.py) against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernels in the interpreter
(``interpret=True``, blocks of 256), as tests/test_flash_attention.py
does; the port's side runs the kernels' plain versions (CPU tensors),
through the same autograd Function the card uses. Inputs are made with
numpy from a seed. f32 throughout: the forward and the log-sum-exp agree
to 2e-5 absolute, the gradients to 5e-5 (the two sum in different orders:
the interpreter over 256-key blocks, the port over 64-key tiles and dense
backward products), causal and padded lengths included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads

from distribuuuu_tpu.models.vit import Attention as JAttention
from distribuuuu_tpu.ops import flash_attention as jfa
from distribuuuu_tpu.ops import ring_attention as jra
from distribuuuu_tpu_torch.models.vit import Attention as TAttention
from distribuuuu_tpu_torch.ops import ring_attention as tra
from distribuuuu_tpu_torch.ops.cuda import flash_attention as tfa

BLK = dict(blk_q=256, blk_k=256)
SHAPES = [(2, 3, 512, 64), (1, 2, 300, 64), (2, 2, 640, 32)]


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads()


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_lse_match_jax_interpret(shape, causal):
    arrs = _inputs(shape, 0)
    jo, jlse = jfa.flash_attention_with_lse(*map(jnp.asarray, arrs), causal=causal,
                                            interpret=True, **BLK)
    with torch.no_grad():
        to, tlse = tfa.flash_attention_with_lse(*_t(arrs), causal=causal)
        plain = tfa.flash_attention(*_t(arrs), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5)
    assert torch.equal(plain, to)
    assert tfa.launch_counts() == {"forward": 0, "dq": 0, "dkdv": 0}  # CPU: plain versions


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [512, 300])
def test_gradients_match_jax_interpret(L, causal):
    arrs = _inputs((1, 2, L, 64), 1)
    w = np.random.default_rng(2).standard_normal((64,)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal, interpret=True, **BLK) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    q, k, v = _t(arrs, grad=True)
    loss = (tfa.flash_attention(q, k, v, causal=causal) * torch.from_numpy(w)).sum()
    tg = torch.autograd.grad(loss, (q, k, v))
    for a, b, name in zip(tg, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=name)


def test_lse_cotangent_folds_into_delta_as_in_jax():
    """Both outputs of flash_attention_with_lse carry a cotangent (the
    ring attention's use): dQ/dK/dV as JAX's vjp, L padded, causal."""
    arrs = _inputs((1, 2, 300, 64), 3)
    rng = np.random.default_rng(4)
    w, u = rng.standard_normal((64,)).astype(np.float32), \
        rng.standard_normal((1, 2, 300)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=True, interpret=True, **BLK)
        return jnp.sum(o * w) + jnp.sum(lse * u)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    q, k, v = _t(arrs, grad=True)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    loss = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(u)).sum()
    for a, b, name in zip(torch.autograd.grad(loss, (q, k, v)), jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_and_reference_match_jax(causal):
    """The plain-torch single-device attention against JAX's (L = 300 over
    chunks of 128: a padded, masked last chunk), forward and gradients."""
    arrs = _inputs((2, 2, 300, 32), 5)
    w = np.random.default_rng(6).standard_normal((32,)).astype(np.float32)
    for jfn, tfn, kw in ((jra.blockwise_attention, tra.blockwise_attention, {"chunk": 128}),
                         (jra.reference_attention, tra.reference_attention, {})):
        def jloss(q, k, v, jfn=jfn, kw=kw):
            return jnp.sum(jfn(q, k, v, causal=causal, **kw) * w)

        jout = jfn(*map(jnp.asarray, arrs), causal=causal, **kw)
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
        q, k, v = _t(arrs, grad=True)
        out = tfn(q, k, v, causal=causal, **kw)
        tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (q, k, v))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)


def test_bf16_plain_forward_rounds_where_the_pallas_body_does():
    """bf16 inputs: p is rounded to bf16 before p·V on both sides. The
    online-softmax tiles differ (256 keys in the interpreter, 64 here), so
    the rounded p differ by up to one bf16 ulp: agreement to 2e-2."""
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, _inputs((1, 2, 300, 64), 7))]
    jo = jfa.flash_attention(*arrs, interpret=True, **BLK)
    with torch.no_grad():
        to = tfa.flash_attention(*(torch.from_numpy(np.array(a.astype(jnp.float32)))
                                   .bfloat16() for a in arrs))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("seq_len,dropout", [(1023, 0.0), (1024, 0.0), (4096, 0.0),
                                             (4096, 0.1), (196, 0.0)])
def test_resolve_impl_threshold_matches_jax(seq_len, dropout):
    for impl in ("auto", "xla", "flash", "blockwise"):
        assert TAttention.resolve_impl(impl, seq_len, dropout) == \
            JAttention.resolve_impl(impl, seq_len, dropout)
    assert TAttention.FLASH_MIN_SEQ == JAttention.FLASH_MIN_SEQ == 1024


def test_refusals():
    q = torch.zeros(1, 1, 8, 160)
    with pytest.raises(ValueError, match="head_dim 160 > 128"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one \\[B, H, L, D\\] shape"):
        tfa.flash_attention(torch.zeros(1, 1, 8, 64), torch.zeros(1, 1, 9, 64),
                            torch.zeros(1, 1, 8, 64))
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tra.ring_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tra.ulysses_attention(q, q, q)
    assert [tfa.padded_head_dim(d) for d in (8, 32, 40, 64, 65, 128)] == \
        [32, 32, 64, 64, 128, 128]


def test_kernel_accounting():
    """The bytes and operations chip_smoke.py's bounds are built from."""
    b = tfa.pass_bytes(192, 196, 64, torch.bfloat16)
    t = 192 * 196 * 64 * 2
    assert b == {"forward": 4 * t + 192 * 196 * 4, "dq": 5 * t + 2 * 192 * 196 * 4,
                 "dkdv": 6 * t + 2 * 192 * 196 * 4}
    f = tfa.flops(12, 4096, 64)
    assert f["forward"] == 4 * 12 * 4096 ** 2 * 64 and f["dkdv"] == 2 * f["forward"]
    assert tfa.flops(1, 4, 8, causal=True)["forward"] == 4 * 10 * 8
