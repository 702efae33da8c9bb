"""The port's FLOP/byte ledger (distribuuuu_tpu_torch/telemetry/costmodel.py)
against the JAX package's cost model.

* ResNet-50's train step at 224² counts within 10 % of the JAX hand
  table's 3 × 2 × 4.09 GFLOP an image (JAX's own cross-check); its eval
  forward within 10 % of 2 × 4.09; the step is memory-bound.
* A count on the meta device is the same on repeated calls and touches
  no live state: parameters, buffers, optimizer moments, torch's and
  Python's generators are as they were.
* ``mfu_value``, ``roofline_point`` and ``analytic_step_flops`` equal
  JAX's on the same inputs; the records validate.
* The memory record reads a graph's first-call peak against the
  capacity; the CPU (no graph) writes none.
* The LM tiles: a decode tile counts 2 × params flops a token, roughly.
"""

from __future__ import annotations

import json
import random

import pytest
import torch
from torch_port_util import few_threads, reset_port_cfg

import distribuuuu_tpu_torch.config as tconfig
from distribuuuu_tpu.telemetry import costmodel as jcost
from distribuuuu_tpu_torch import trainer
from distribuuuu_tpu_torch.config import cfg as tcfg
from distribuuuu_tpu_torch.telemetry import costmodel, schema, spans
from distribuuuu_tpu_torch.utils.optim import construct_optimizer

TABLE_TRAIN = 3 * 2 * 4.09e9  # JAX's hand table, ResNet-50 train, an image at 224²


@pytest.fixture(autouse=True)
def _clean():
    reset_port_cfg()
    costmodel.reset()
    yield from few_threads(4)
    spans.close_telemetry()
    costmodel.reset()
    reset_port_cfg()


@pytest.fixture(scope="module")
def resnet50():
    """config/resnet50.yaml's model (bf16 compute, fp32 masters) and
    optimizer on the CPU, in train mode."""
    reset_port_cfg()
    tconfig.merge_from_file("config/resnet50.yaml")
    model = trainer.build_model_from_cfg().train()
    opt = construct_optimizer(model)
    yield model, opt
    reset_port_cfg()


def _batch(n: int, im: int = 224):
    return {"image": torch.zeros((n, im, im, 3), dtype=torch.uint8),
            "label": torch.zeros((n,), dtype=torch.int32),
            "mask": torch.ones((n,))}


def test_resnet50_train_step_within_ten_percent_of_the_table(resnet50):
    model, opt = resnet50
    c = costmodel.count(trainer._train_work(model, opt, _batch(4), topk=5, accum=1))
    per_image = c["flops"] / 4
    assert per_image == pytest.approx(TABLE_TRAIN, rel=0.10), per_image / 1e9
    peaks = dict(costmodel.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"], kind="H100")
    roof = costmodel.roofline_point(c["flops"], c["bytes_accessed"], peaks)
    assert roof["bound"] == "memory"
    assert roof["arithmetic_intensity"] < roof["ridge_intensity"] / 10


def test_resnet50_eval_forward_and_repeat_counts(resnet50):
    model, _ = resnet50
    model.eval()
    try:
        work = trainer._eval_work(model, _batch(2), topk=5)
        a, b = costmodel.count(work), costmodel.count(work)
    finally:
        model.train()
    assert a == b
    assert a["flops"] / 2 == pytest.approx(2 * 4.09e9, rel=0.10)


def test_counting_touches_no_live_state():
    tcfg.merge_from_list(["MODEL.ARCH", "resnet18", "MODEL.NUM_CLASSES", 10,
                          "DEVICE.COMPUTE_DTYPE", "float32"])
    model = trainer.build_model_from_cfg().train()
    opt = construct_optimizer(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [m.clone() for m in opt.m]
    torch_state, py_state = torch.get_rng_state(), random.getstate()
    c = costmodel.count(trainer._train_work(model, opt, _batch(4, 32), topk=5, accum=2))
    assert c["flops"] > 0 and c["ops"] > 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(opt.m, moments))
    assert opt.count == 0 and opt.scal is None and model.training
    assert torch.equal(torch.get_rng_state(), torch_state) and random.getstate() == py_state
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("flops,step_s,peak", [(24.5e9 * 32, 0.03867, 989.4e12),
                                               (1.0, 0.0, 1.0), (0.0, 1.0, 1.0),
                                               (5e12, 2.0, 1e12)])
def test_mfu_equals_jax(flops, step_s, peak):
    assert costmodel.mfu_value(flops, step_s, peak) == jcost.mfu_value(flops, step_s, peak)


@pytest.mark.parametrize("flops,nbytes,peaks", [
    (7.8e11, 8.06e10, {"flops": 989.4e12, "bytes_per_s": 3.35e12}),
    (1e15, 1e11, {"flops": 989.4e12, "bytes_per_s": 3.35e12}),
    (1e9, None, {"flops": 1e11, "bytes_per_s": 25.6e9}),
    (1e9, 1e9, None),
    (None, 1e9, None),
])
def test_roofline_point_equals_jax(flops, nbytes, peaks):
    assert costmodel.roofline_point(flops, nbytes, peaks) == \
        jcost.roofline_point(flops, nbytes, peaks)


@pytest.mark.parametrize("arch", ["resnet50", "resnet18", "regnety_160", "vit_small"])
@pytest.mark.parametrize("train", [True, False])
def test_the_hand_table_equals_jax(arch, train):
    assert costmodel.ANALYTIC_FWD_FLOPS_PER_IMG == jcost.ANALYTIC_FWD_FLOPS_PER_IMG
    assert costmodel.TRAIN_FLOPS_MULT == jcost.TRAIN_FLOPS_MULT
    assert costmodel.analytic_step_flops(arch, 32, train) == \
        jcost.analytic_step_flops(arch, 32, train)


def test_ledger_records_validate_and_fall_back_to_the_table():
    peaks = costmodel.peaks_for("cpu")
    assert peaks["kind"] == "cpu" and peaks["nominal"] and peaks["capacity_bytes"]
    led = costmodel.build_ledger("train_step", "train",
                                 {"flops": 7.8e11, "bytes_accessed": 8.1e10}, None,
                                 images=32, peaks=peaks)
    assert led["step"]["source"] == led["roofline"]["source"] == "dispatch"
    assert led["memory"] is None
    fb = costmodel.build_ledger("train_step", "train", None, {"total_bytes": 2 ** 30},
                                images=32, arch="resnet50", peaks=peaks)
    assert fb["step"]["source"] == "analytic" and fb["step"]["flops"] == 32 * TABLE_TRAIN
    assert fb["memory"]["source"] == "graph"
    assert fb["memory"]["headroom_pct"] == round((1 - 2 ** 30 / peaks["capacity_bytes"])
                                                 * 100, 2)
    for kind, rec in (("cost.step", led["step"]), ("cost.roofline", led["roofline"]),
                      ("cost.step", fb["step"]), ("cost.memory", fb["memory"])):
        schema.validate_record({"kind": kind, **rec})
    assert costmodel.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["flops"] == 989.4e12
    assert costmodel.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["bytes_per_s"] == 3.35e12


class _Graph:
    first_call_peak = 3 * 2 ** 30


def test_capture_once_per_label_and_the_memory_record(tmp_path):
    path = spans.setup_telemetry(str(tmp_path), rank=0)
    a, b = torch.empty((4, 8), device="meta"), torch.empty((8, 2), device="meta")

    def work():
        return a @ b

    led = costmodel.capture_step(work, label="x", phase="eval", images=4, device="cpu")
    assert led["step"]["flops"] == 2 * 4 * 8 * 2
    assert costmodel.capture_step(work, label="x", phase="eval", images=4, device="cpu") is None
    assert costmodel.capture_memory(object(), label="x", phase="eval", device="cpu") is None
    mem = costmodel.capture_memory(_Graph(), label="x", phase="eval", device="cpu")
    assert mem["total_bytes"] == 3 * 2 ** 30 and mem["headroom_pct"] < 100
    assert costmodel.capture_memory(_Graph(), label="x", phase="eval", device="cpu") is None
    spans.flush()
    recs = [json.loads(x) for x in open(path).read().splitlines()]
    assert [r["kind"] for r in recs] == ["clock", "cost.step", "cost.roofline", "cost.memory"]
    for r in recs:
        schema.validate_record(r)


def test_a_failed_count_falls_back_to_the_table(tmp_path):
    spans.setup_telemetry(str(tmp_path), rank=0)

    def broken():
        raise RuntimeError("no meta kernel")

    led = costmodel.capture_step(broken, label="y", phase="train", images=2, device="cpu",
                                 arch="resnet50")
    assert led["step"]["source"] == "analytic" and led["step"]["flops"] == 2 * TABLE_TRAIN


def test_lm_decode_tile_counts_two_flops_a_parameter_a_token():
    from torch_port_util import jax_gpt, port_gpt, random_variables

    from distribuuuu_tpu_torch.lm import generate as tgen

    jm, shapes = jax_gpt(seq_len=32)
    model = port_gpt(jm, random_variables(shapes, seed=5))
    eng = tgen.GenerateEngine(model, device=torch.device("cpu"), prompt_len=8,
                              max_new_tokens=8, batch_tiles=[1, 2], cache_tiles=[16, 32],
                              eos_id=-1)
    try:
        dec = tgen.GPTDecoder(costmodel.meta_copy(eng.model), eng.decoder.blk)
        c = costmodel.count(eng._tile_work(dec, 2, 32, 1))
    finally:
        eng.drain()
    matmul_params = sum(p.numel() for n, p in eng.model.named_parameters()
                        if p.dim() == 2 and "embed" not in n)
    assert c["flops"] >= 2 * 2 * matmul_params
    assert c["flops"] < 2 * 2 * matmul_params * 1.5


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_a_grouped_conv_backward_counts_twice_its_forward(groups):
    """Input and weight gradients: twice the forward's FLOPs whatever the
    groups (the library formula alone counts a grouped backward G times
    over)."""
    x = torch.empty((2, 16, 8, 8), device="meta", requires_grad=True)
    w = torch.empty((32, 16 // groups, 3, 3), device="meta", requires_grad=True)

    def fwd():
        return torch.nn.functional.conv2d(x, w, padding=1, groups=groups)

    f = costmodel.count(fwd)["flops"]
    assert f == 2 * 2 * 32 * 8 * 8 * (16 // groups) * 9
    both = costmodel.count(lambda: torch.autograd.grad(fwd().sum(), (x, w)))["flops"]
    assert both == 3 * f
