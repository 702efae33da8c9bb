"""Weight-only quantized serving (distribuuuu_tpu_torch/serve/quantize.py
and the engine's ``SERVE.QUANTIZE``), held against the JAX package's
serve/quantize.py: the packed int8, the scales and the byte meta bitwise
JAX's after the layout transposition (a CNN, and a ViT whose
``pos_embed`` keeps JAX's axis last), the quantized forward JAX's
``model.apply(dequantize_in_graph(packed))`` within FWD_TOL, the
referee's delta within ``TOLERANCE``, and the engine serving every bucket
quantized."""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from torch_port_util import (
    few_threads,
    jax_regnet,
    jax_vit,
    port_regnet,
    random_variables,
    reset_port_cfg,
)

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.serve import quantize as jq
from distribuuuu_tpu_torch import telemetry
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.models import build_model
from distribuuuu_tpu_torch.serve import Engine, engine_from_cfg
from distribuuuu_tpu_torch.serve import quantize as tq
from distribuuuu_tpu_torch.telemetry import schema
from distribuuuu_tpu_torch.utils import weights

# max |port - JAX| over max |JAX| logit from the same packed weights: f32
# arithmetic after an int8 dequant on both sides; under bf16 JAX folds the
# BN in the leaves' bf16 (rsqrt(var + eps) * scale keeps the dtype of the
# bf16 statistics) where the port widens them to f32 first
FWD_TOL = {"int8": 1e-5, "bf16": 2e-3}
IM = 32


@pytest.fixture(autouse=True)
def _port_cfg():
    reset_port_cfg()
    yield
    reset_port_cfg()


@pytest.fixture(autouse=True)
def _threads():
    yield from few_threads(2)


@pytest.fixture(scope="module")
def cnn():
    jmodel, shapes = jax_regnet(num_classes=10, im=IM)
    v = random_variables(shapes, seed=11)
    return jmodel, v, lambda: port_regnet(jmodel, v)


@pytest.fixture(scope="module")
def vit():
    jmodel, shapes = jax_vit("vit_tiny", num_classes=10, im=IM, depth=2)
    v = random_variables(shapes, seed=12)

    def port():
        m = build_model("vit_tiny", num_classes=10, dtype=torch.float32, depth=2, img_size=IM)
        m.load_state_dict(weights.state_dict_from_jax(v["params"]))
        return m.eval()

    return jmodel, v, port


def _jax_packed_in_port_layout(v, mode):
    """JAX's packed tree under the port's keys and layout: {key: (q, scale)}
    for int8 leaves, {key: bf16 bits as uint16} for bf16."""
    packed, meta = jq.quantize_variables(v, mode)
    paths = weights.jax_path_map(v["params"])
    out = {}

    def walk(node, path=()):
        if jq._is_q8(node):
            key = paths[path]
            out[key] = (weights._port_layout(node["q8"], np.int8, key),
                        weights._port_layout(node["q8_scale"], np.float32, key))
            return
        if isinstance(node, dict):
            for k, c in node.items():
                walk(c, (*path, k) if path or k not in ("params", "batch_stats") else ())
            return
        arr = np.asarray(node)
        if arr.dtype == jax.numpy.bfloat16:
            key = paths[path]
            out[key] = weights._port_layout(arr.view(np.uint16), np.uint16, key)

    walk(packed)
    return out, meta


@pytest.mark.parametrize("which", ["cnn", "vit"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_packed_and_meta_equal_jax(request, which, mode):
    _, v, port = request.getfixturevalue(which)
    want, jmeta = _jax_packed_in_port_layout(v, mode)
    packed, meta = tq.quantize_state(port(), mode)
    assert meta == jmeta
    assert set(packed) == set(want)
    for key, p in packed.items():
        if mode == "int8":
            q, s = want[key]
            assert p[1].numpy().tobytes() == q.tobytes() and p[1].shape == q.shape, key
            assert p[2].numpy().tobytes() == s.tobytes() and p[2].shape == s.shape, key
        else:
            assert p[1].view(torch.int16).numpy().view(np.uint16).tobytes() == want[key].tobytes()
    if which == "vit" and mode == "int8":  # JAX's last axis stays last where the layout does
        assert packed["pos_embed"][3] == 2 and packed["pos_embed"][2].shape[-1] == 192


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_forward_equals_jax(cnn, mode):
    """The engine's buckets (eager on the CPU: the same body a graph
    replays) against JAX's forward of its own packed weights, dequantized."""
    jmodel, v, port = cnn
    packed, _ = jq.quantize_variables(v, mode)
    x = np.random.default_rng(3).standard_normal((3, IM, IM, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(jq.dequantize_in_graph(p), x,
                                                       train=False))(packed, x))
    eng = Engine(port(), IM, device="cpu", max_batch=4, bucket_sizes=[1, 4],
                 input_dtype=np.float32, quantize=mode).start()
    got = np.stack([f.result() for f in [eng.submit(img) for img in x]])
    eng.drain()
    assert np.max(np.abs(got - ref)) <= FWD_TOL[mode] * np.max(np.abs(ref))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_delta_within_tolerance(cnn, mode):
    jmodel, v, port = cnn
    x = np.random.default_rng(4).standard_normal((4, IM, IM, 3)).astype(np.float32)
    model = port()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = tq.quantized_delta(model, torch.from_numpy(x), mode)
    # JAX's referee (serve/quantize.quantized_delta), its two forwards jitted
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    packed, meta = jq.quantize_variables(v, mode)
    ref = np.asarray(fwd(v, x))
    want = np.max(np.abs(np.asarray(fwd(jq.dequantize_in_graph(packed), x)) - ref)) / np.max(
        np.abs(ref))
    assert got["ok"] and want <= jq.TOLERANCE[mode]
    assert got["rel_logits_delta"] <= tq.TOLERANCE[mode] == jq.TOLERANCE[mode]
    assert abs(got["rel_logits_delta"] - want) <= FWD_TOL[mode]
    for k in ("bytes_before", "bytes_after", "quantized_leaves"):
        assert got[k] == meta[k]
    for k, t in model.state_dict().items():  # the referee leaves the weights as they were
        assert torch.equal(t, before[k]), k


def test_engine_serves_every_bucket_quantized(tmp_path, cnn):
    """int8 through ``engine_from_cfg``: every bucket serves, the answers
    are the dequantized weights' forward, the model holds no
    full-precision copy of a packed weight, ``stats()`` names the mode,
    the ledger's labels carry it, and the ``serve.quantized`` record
    validates with JAX's byte meta."""
    jmodel, v, port = cnn
    ref_model = port()
    sd = ref_model.state_dict()
    tconfig.merge_from_file("config/resnet18.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "DEVICE.COMPUTE_DTYPE", "float32",
                          "MODEL.NUM_CLASSES", 10, "TRAIN.IM_SIZE", IM,
                          "SERVE.BUCKET_SIZES", [1, 2, 4], "SERVE.MAX_BATCH", 4,
                          "SERVE.QUANTIZE", "int8", "OUT_DIR", str(tmp_path)])
    from distribuuuu_tpu_torch import trainer

    orig = trainer.build_model_from_cfg
    trainer.build_model_from_cfg = lambda: port()  # the toy RegNet under resnet18's cfg
    telemetry.setup_from_cfg(tcfg, rank=0)
    try:
        eng = engine_from_cfg()
    finally:
        trainer.build_model_from_cfg = orig
    assert eng.quantize_mode == "int8" and eng.stats()["quantize"] == "int8"
    packed, meta = tq.quantize_state(ref_model, "int8")
    assert eng.quantize_meta == meta
    for key in packed:  # the only copy of a packed weight is the packed one
        assert eng._packed.shapes[key] == tuple(sd[key].shape)
    deq = tq.dequantize_state(packed)
    ref_model.load_state_dict({**sd, **deq})
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (7, IM, IM, 3)).astype(np.uint8)
    from distribuuuu_tpu_torch.data.transforms import normalize_on_device

    with torch.no_grad():
        want = ref_model.prepare()(normalize_on_device(torch.from_numpy(imgs))).numpy()
    eng.start()
    got = []
    for lo, hi in ((0, 1), (1, 3), (3, 7)):  # buckets 1, 2, 4
        futs = [eng.submit(img) for img in imgs[lo:hi]]
        got += [f.result() for f in futs]
    eng.drain()
    telemetry.close_telemetry()
    np.testing.assert_allclose(np.stack(got), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert eng.stats()["batches"] >= 3
    recs = [json.loads(line) for line in open(tmp_path / "telemetry" / "rank00000.jsonl")]
    q = [r for r in recs if r["kind"] == "serve.quantized"]
    assert len(q) == 1
    schema.validate_record(q[0])
    assert {k: q[0][k] for k in ("bytes_before", "bytes_after", "leaves")} == {
        k: meta[k] for k in ("bytes_before", "bytes_after", "leaves")}
    labels = {r["label"] for r in recs if r["kind"] == "cost.step"}
    assert labels == {f"serve_bucket_{b}_int8" for b in (1, 2, 4)}


def test_unknown_mode_refused(cnn):
    with pytest.raises(ValueError, match="SERVE.QUANTIZE must be one of"):
        tq.quantize_state(cnn[2](), "fp4")
    tconfig.merge_from_file("config/resnet18.yaml")
    tcfg.merge_from_list(["DEVICE.PLATFORM", "cpu", "SERVE.QUANTIZE", "fp4"])
    with pytest.raises(ValueError, match="SERVE.QUANTIZE must be one of"):
        engine_from_cfg()


def test_channel_axis_follows_the_layout():
    """JAX's last axis in the port's layout: first for conv and Linear
    weights, last for what the layout keeps (tables, pos_embed)."""
    assert tq.channel_axis("layer1.0.conv1.weight", 4) == 0
    assert tq.channel_axis("fc.weight", 2) == 0
    assert tq.channel_axis("tok_embed.weight", 2) == 1
    assert tq.channel_axis("layer4.0.mhsa.rel_height", 2) == 1
    assert tq.channel_axis("pos_embed", 3) == 2
