"""Tests of the port that need the card (marker ``cuda``; they skip without
CUDA). No JAX here, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CUDA kernel is held against its plain version (tolerances as in
tests/test_torch_conv_epilogue.py), and a small ResNet-50 is served on the
card through the engine, every fused site launching the kernel.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distribuuuu_tpu_torch.data.transforms import normalize_on_device
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.ops.cuda import conv_epilogue as ce
from distribuuuu_tpu_torch.serve import Engine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 0.0625}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,cin,cout,act", [((2, 5, 5), 48, 96, "relu"),
                                               ((3, 7, 5), 37, 53, "silu")])
def test_kernel_matches_plain_on_card(dtype, lead, cin, cout, act):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(*lead, cin, device=dev, generator=g).to(dtype)
    w = (0.1 * torch.randn(cin, cout, device=dev, generator=g)).to(dtype)
    a = 1.0 + 0.3 * torch.randn(cout, device=dev, generator=g)
    c = 0.2 * torch.randn(cout, device=dev, generator=g)
    before = ce.conv1x1_bn_act.launches
    got = ce.conv1x1_bn_act(x, w, a, c, act)
    ref = ce.conv1x1_bn_act_plain(x, w, a, c, act)
    torch.cuda.synchronize()
    assert ce.conv1x1_bn_act.launches == before + 1
    assert got.dtype == dtype and got.shape == (*lead, cout)
    assert float((got.float() - ref.float()).abs().max()) <= TOL[dtype]


def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    x = torch.randn(4, 8, device=dev)
    w, a, c = torch.randn(8, 4, device=dev), torch.ones(4, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ce.conv1x1_bn_act(torch.randn(8, 4, device=dev).t(), w, a, c)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ce.conv1x1_bn_act(x.half(), w.half(), a, c)
    with pytest.raises(ValueError, match="on cpu"):
        ce.conv1x1_bn_act(x, w.cpu(), a, c)


def test_engine_on_card_launches_kernel_at_every_fused_site():
    dev = _card()
    model = build_model("resnet50", num_classes=10, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    ref = build_model("resnet50", num_classes=10, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ce.conv1x1_bn_act.launches = 0
    eng = Engine(model, 32, device=dev, max_batch=4, bucket_sizes=[2, 4],
                 max_wait_ms=50.0, max_queue=16).start()
    images = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3), np.uint8)
    got = np.stack([f.result(timeout=120) for f in [eng.submit(i) for i in images]])
    eng.drain()
    assert ce.conv1x1_bn_act.launches == 33 * (eng.stats()["batches"] + eng.n_compiles)
    with torch.inference_mode():
        cpu = ref.eval()(normalize_on_device(torch.from_numpy(images))).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - cpu).max() / np.abs(cpu).max() <= 0.05  # bf16 card vs f32 CPU
