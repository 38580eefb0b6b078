"""The work counted for the model FLOPs and the kernels' rooflines: one
conv counted by hand, the launches of a step and a request against the
port's launch counts, and the roofline reader's arithmetic."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, peaks
from benchmark.drivers import rollout as rollout_drv
from benchmark.drivers import train as train_drv
from benchmark.reference import counts
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]


def test_one_conv_counted_by_hand():
    # (1, 4, 4, 2) -> 3 channels, 3 x 3, stride 1
    a = counts.launch("A", 1, 4, 4, 2, 3)
    assert a.flops == 2 * 1 * 4 * 4 * 2 * 3 * 9 == 1728
    # input 32 + output 48 bf16 values, kernel 54 bf16, 3 f32 biases and
    # one f32 slope
    assert a.bytes == (32 + 48) * 2 + 54 * 2 + 3 * 4 + 4 == 284
    assert counts.launch("A", 1, 4, 4, 2, 3, residual=True).bytes == 284 + 96
    s2 = counts.launch("A", 1, 4, 4, 2, 3, stride=2)
    assert s2.flops == 2 * 2 * 2 * 2 * 3 * 9
    assert s2.bytes == (32 + 12) * 2 + 54 * 2 + 12 + 4
    # the data gradient reads the 3-channel gradient, writes 2 channels
    t = counts.launch("A", 1, 4, 4, 2, 3, transposed=True)
    assert t.flops == a.flops and t.bytes == (48 + 32) * 2 + 54 * 2 + 16
    b = counts.launch("B", 1, 4, 4, 3, 3)
    assert b.flops == 2 * 2 * 16 * 3 * 3 * 9
    assert b.bytes == (48 + 48) * 2 + 2 * (81 * 2 + 12 + 4)


def test_flop_counter_counts_a_conv_as_by_hand():
    x = torch.empty((1, 2, 4, 4), device="meta")
    w = torch.empty((3, 2, 3, 3), device="meta")
    assert counts.model_flops(lambda: F.conv2d(x, w, padding=1)) == 1728


def test_roofline_bound_of_one_conv():
    pk = peaks.H100_SXM
    a = counts.launch("A", 16, 256, 256, 32, 32)
    t_ops, t_bytes = a.flops / pk.bf16_flops, a.bytes / pk.bytes_per_s
    # at 32 channels kernel A is bound by bytes: 0.0401 ms (PERF.md, PR 4)
    assert t_bytes > t_ops
    assert t_bytes * 1e3 == pytest.approx(0.0401, abs=2e-4)


def _cell(name):
    return harness.load_cell(ROOT, name)


@pytest.mark.parametrize("config,traffic,a,b", [
    ("coordgridnet_edge", "train_b32", 93, 15),
    ("gridnet_edge", "recipe_k4_b32", 553, 120)])
def test_launches_of_a_train_step(config, traffic, a, b):
    bench = ROOT / "benchmark"
    got = train_drv.launches_per_step(
        json.loads((bench / "configs" / f"{config}.json").read_text()),
        json.loads((bench / "traffic" / f"{traffic}.json").read_text()))
    assert sum(x.kind == "A" for x in got) == a
    assert sum(x.kind == "B" for x in got) == b


@pytest.mark.parametrize("name", ["gridnet_rollout_b16", "gridnet_rollout_b1"])
def test_launches_of_a_request(name):
    cell = _cell(name)
    got = rollout_drv.launches_per_request(cell.config, cell.traffic)
    assert sum(x.kind == "A" for x in got) == 378
    assert sum(x.kind == "B" for x in got) == 120


def test_model_flops_of_a_sample_and_a_request():
    cell = _cell("coordgridnet_train_b32")
    per_sample = train_drv.step_flops(cell.config, cell.traffic) / 32
    # 3 x 63.3 (CoordGridNet forward and backward) + 2 x 40.1 (HED) +
    # 3 x 46.1 (VGG19: two forwards, one data gradient), GFLOP
    assert per_sample / 1e9 == pytest.approx(3 * 63.3 + 2 * 40.1 + 3 * 46.1,
                                             rel=0.01)
    cell = _cell("gridnet_rollout_b16")
    req = rollout_drv.request_flops(cell.config, cell.traffic)
    # 8 GridNet forwards and 9 HED (the last frame's edges are not read)
    assert req / 1e12 == pytest.approx(16 * (8 * 63.0 + 9 * 40.1) / 1e3,
                                       rel=0.01)


def test_roofline_reader():
    cell = _cell("gridnet_rollout_b16")
    rd = harness.reader(cell, "conv_roofline.rollout")
    launches = [counts.launch("A", 16, 256, 256, 32, 32)] * 2 + [
        counts.launch("B", 16, 256, 256, 32, 32)]
    tr = Trace(wall_s=1.0, window=(0.0, 1e6), device=[
        ("conv3x3_mma_kernel", 0.0, 100.0), ("conv3x3_mma_kernel", 100.0,
                                             200.0),
        ("fused_lateral_mma_kernel", 200.0, 500.0), ("other", 0.0, 9e5)])
    ctx = dict(trace=tr, conv_launches=launches, device_name="NVIDIA H100 "
               "80GB HBM3", counters={"prelu_conv3x3": 2,
                                      "fused_lateral": 1}, log=lambda m: None)
    pk = peaks.H100_SXM
    bound = sum(max(x.flops / pk.bf16_flops, x.bytes / pk.bytes_per_s)
                for x in launches)
    assert rd.read(ctx) == pytest.approx(100 * bound / 500e-6)
    assert rd.read(dict(ctx, counters={"prelu_conv3x3": 3,
                                       "fused_lateral": 1})) is None
    assert rd.read(dict(ctx, device_name="cpu")) is None
