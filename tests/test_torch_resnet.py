"""The port's ResNet family (distribuuuu_tpu_torch/models) against the JAX
models on the same weights.

Eval logits agree within rtol=1e-4, atol=1e-4 in f32: XLA and oneDNN sum
the convs in different orders, and at the pointwise sites the port folds
BN into the fused epilogue's fp32 affine where the JAX CPU path
(``KERNELS.CONV_EPILOGUE auto`` → XLA) normalizes the conv output.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_port_util import jax_resnet, port_model, random_variables, reset_port_cfg

from distribuuuu_tpu_torch import models as tmodels
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_eval_logits_match_jax(arch):
    model, shapes = jax_resnet(arch)
    v = random_variables(shapes, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x))
    with torch.inference_mode():
        got = port_model(arch, v)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_resnet50_param_count_matches_jax():
    _, shapes = jax_resnet("resnet50", num_classes=1000, im=64)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    m = tmodels.build_model("resnet50", num_classes=1000)
    assert sum(p.numel() for p in m.parameters()) == n_jax == 25_557_032


@pytest.mark.parametrize("arch,fused", [("resnet18", 0), ("resnet50", 33),
                                        ("resnext50_32x4d", 33), ("wide_resnet50_2", 33)])
def test_fused_sites(arch, fused):
    """Per forward: every bottleneck conv1/conv3 and the stride-1 stage-1
    downsample take the fused epilogue; 3x3s and strided 1x1s do not."""
    m = tmodels.build_model(arch, num_classes=10, dtype=torch.float32)
    assert sum(u.fused for u in m.conv_units()) == fused
    reasons = {u.reason for u in m.conv_units() if not u.fused}
    assert reasons <= {"kernel (3, 3) is not pointwise (1, 1)",
                       "kernel (7, 7) is not pointwise (1, 1)", "stride (2, 2) != (1, 1)"}


def test_seeded_init_is_deterministic_and_bf16_forward_runs():
    a = tmodels.build_model("resnet18", num_classes=10,
                            generator=torch.Generator().manual_seed(3))
    b = tmodels.build_model("resnet18", num_classes=10,
                            generator=torch.Generator().manual_seed(3))
    c = tmodels.build_model("resnet18", num_classes=10,
                            generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        y = a.eval().prepare()(x)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()  # bf16 body, fp32 head


def test_unported_paths_raise_with_roadmap_item():
    tcfg.DEVICE.S2D_STEM = True
    with pytest.raises(NotImplementedError, match="S2D stem"):
        trainer.build_model_from_cfg()
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tmodels.build_model("vit_tiny_moe")  # the image zoo is ported; the MoE ViT is not
    with pytest.raises(NotImplementedError, match="Parallel layouts beyond DP"):
        tmodels.build_model("gpt_nano_moe")
    with pytest.raises(KeyError, match="Unknown arch"):
        tmodels.build_model("alexnet")
