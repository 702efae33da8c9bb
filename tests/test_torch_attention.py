"""The port's relative-position attention ops (distribuuuu_tpu_torch/ops/
attention.py) against the JAX package's (distribuuuu_tpu/ops/attention.py)
on the same numpy-seeded inputs at f64: within the last ulp of each
output's scale (the einsums may sum in another order), and the
pad-reshape ``rel_to_abs`` exactly. ``mhsa_2d`` runs its softmax in fp32
even at f64, on both sides, so its last ulp is fp32's (XLA's and
PyTorch's fp32 ``exp`` differ in it). Also the dtype policy of ``mhsa_2d`` (an fp32
softmax whose weights come back in ``v.dtype``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import few_threads

from distribuuuu_tpu.ops import attention as jatt
from distribuuuu_tpu_torch.ops import attention as tatt

MAX_ULP = 1  # ulps of the output's largest magnitude


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


def _cases(rng):
    """name -> (port fn, JAX fn, inputs, the dtype of the last ulp; None:
    exact)."""
    b, n, h, w, d = 2, 3, 3, 4, 5
    q = rng.standard_normal((b, n, h * w, d))
    return {
        "rel_to_abs": (tatt.rel_to_abs, jatt.rel_to_abs,
                       (rng.standard_normal((b, n, 5, 9)),), None),
        "relative_logits_1d": (tatt.relative_logits_1d, jatt.relative_logits_1d,
                               (rng.standard_normal((b, n, h, w, d)),
                                rng.standard_normal((2 * w - 1, d))), np.float64),
        "rel_pos_logits": (lambda *a: tatt.rel_pos_logits(*a, h, w),
                           lambda *a: jatt.rel_pos_logits(*a, h, w),
                           (q, rng.standard_normal((2 * h - 1, d)),
                            rng.standard_normal((2 * w - 1, d))), np.float64),
        "abs_pos_logits": (tatt.abs_pos_logits, jatt.abs_pos_logits,
                           (q, rng.standard_normal((h, d)), rng.standard_normal((w, d))),
                           np.float64),
        "mhsa_2d": (lambda *a: tatt.mhsa_2d(*a, d ** -0.5),
                    lambda *a: jatt.mhsa_2d(*a, d ** -0.5),
                    (q, rng.standard_normal((b, n, h * w, d)),
                     rng.standard_normal((b, n, h * w, d)),
                     rng.standard_normal((b, n, h * w, h * w))), np.float32),
    }


@pytest.mark.parametrize("name", ["rel_to_abs", "relative_logits_1d", "rel_pos_logits",
                                  "abs_pos_logits", "mhsa_2d"])
def test_matches_jax_at_f64(x64, name):
    port, ref, inputs, ulp = _cases(np.random.default_rng(0))[name]
    want = np.asarray(ref(*map(jnp.asarray, inputs)))
    got = port(*map(torch.from_numpy, inputs)).numpy()
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    if ulp is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MAX_ULP * np.spacing(ulp(np.abs(want).max())))


def test_mhsa_softmax_in_fp32_weights_in_v_dtype():
    """bf16 q, k, v with fp32 position logits: the output is bf16 and
    equals the same steps spelled out (logits in bf16, the sum with pos
    and the softmax in fp32, the weights cast to bf16 before PV)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 6, 8))).to(torch.bfloat16)
               for _ in range(3))
    pos = torch.from_numpy(rng.standard_normal((1, 2, 6, 6))).float()
    out = tatt.mhsa_2d(q, k, v, pos, 8 ** -0.5)
    logits = torch.einsum("bnxd,bnyd->bnxy", q * 8 ** -0.5, k)
    assert logits.dtype == torch.bfloat16
    weights = torch.softmax(logits.float() + pos, -1).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.einsum("bnxy,bnyd->bnxd", weights, v))
