"""The cell ``resnet9_train_b32`` on the CPU: the work its counts give an
InstanceNorm launch and a step, its four per-layer readers on hand-built
traces, and its check, which passes the port's float32 path and fails the
float8 control and each planted fault, at a small size.

The tiny tree of ``conftest`` cuts every cell of BENCHMARK.json; this
module gives it the traffic of the ``train_resnet`` driver (the train
cells' tiny settings), the generator at ngf 8 and limits of its own, set
from float32 readings at that size (below)."""

import json
import time
from pathlib import Path

import pytest
import torch

import conftest
from benchmark import harness, trace
from benchmark.reference import resnet_counts

conftest.TINY_TRAFFIC.setdefault("train_resnet",
                               conftest.TINY_TRAFFIC["train"])

ROOT = Path(__file__).resolve().parents[2]
CELL = "resnet9_train_b32"
SEED = 2 ** 31 + 11
H100 = "NVIDIA H100 80GB HBM3"
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "resnet9_edge.json").read_text())
# the port's float32 path against the float32 reference at ngf 8, 32 px
# reads up to 3e-5 in the gradient gap and 6.4e-4 in the median change on
# four seeds; an InstanceNorm with the unbiased variance reads 1.4e-3 and
# one with no epsilon 6.7e-3 in the gradient gap, half the batch 0.45 and
# the float8 control 0.09 or more
TINY_LIMITS = {"worst_grad_gap": 3e-4, "worst_tensor_grad_gap": 3e-4,
               "median_change_gap": 5e-3}


@pytest.fixture
def tiny_resnet(tiny):
    bench = tiny / "benchmark"
    path = bench / "configs" / "resnet9_edge.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), ngf=8)))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return tiny


def run(tiny):
    return harness.run_cell(tiny, CELL, SEED, 0.3, False, time.time(), "cpu",
                            log=lambda m: None)


# ---- counts -----------------------------------------------------------------

def test_the_work_of_one_instance_norm_launch():
    fwd = resnet_counts.norm_launch(2, 4, 4, 8)
    bwd = resnet_counts.norm_launch(2, 4, 4, 8, backward=True)
    assert (fwd.kind, fwd.flops, fwd.bytes) == ("norm_fwd", 6 * 256,
                                                2 * 256 * 2 + 16 * 4)
    assert (bwd.kind, bwd.flops, bwd.bytes) == ("norm_bwd", 7 * 256,
                                                3 * 256 * 2 + 16 * 4)


def test_the_norms_of_a_step_at_the_published_widths():
    traffic = {"batch": 32}
    shapes = resnet_counts.forward_shapes(CONFIG, 32)
    assert shapes == ([(32, 256, 256, 64), (32, 128, 128, 128)]
                      + [(32, 64, 64, 256)] * 19
                      + [(32, 128, 128, 128), (32, 256, 256, 64)])
    launches = resnet_counts.step_norm_launches(CONFIG, traffic)
    assert [x.kind for x in launches] == ["norm_fwd"] * 23 + ["norm_bwd"] * 23
    elems = sum(n * h * w * c for n, h, w, c in shapes)
    assert sum(x.bytes for x in launches) == 5 * 2 * elems + 2 * 32 * (
        2 * 64 + 2 * 128 + 19 * 256) * 4


def test_the_generator_s_model_flops_are_its_convs():
    """FlopCounterMode over the reference's generator equals 2 x the
    multiply-adds of its 25 convs at 256 x 256 (a transposed conv's are
    its input's pixels x k x k x Ci x Co)."""
    from benchmark.reference import counts, resnet_gen
    gen = counts.meta_params(resnet_gen.spec_of(CONFIG))
    x = torch.empty((1, 256, 256, 10), device="meta")
    got = counts.model_flops(lambda: resnet_gen.generator(gen, x))
    macs = (256 ** 2 * 49 * 10 * 64 + 128 ** 2 * 9 * 64 * 128
            + 64 ** 2 * 9 * 128 * 256 + 18 * 64 ** 2 * 9 * 256 * 256
            + 64 ** 2 * 9 * 256 * 128 + 128 ** 2 * 9 * 128 * 64
            + 256 ** 2 * 49 * 64 * 23)
    assert got == 2 * macs


# ---- the readers ------------------------------------------------------------

def _trace(fwd=2, bwd=2, spans=2):
    device = ([("void instance_norm_fwd_kernel<__nv_bfloat16, 8>", 10.0 * i,
                10.0 * i + 4.0) for i in range(fwd)]
              + [("void instance_norm_bwd_kernel<__nv_bfloat16, 8>",
                  50.0 + 10.0 * i, 56.0 + 10.0 * i) for i in range(bwd)]
              + [("sm90_xmma_conv", 90.0, 95.0)])
    host = [("bench.slice", 0.0, 100.0)]
    for i in range(spans):
        t = 30.0 * i
        host += [("gen.stem", t, t + 1.0), ("gen.blocks", t + 1.0, t + 4.0),
                 ("gen.up", t + 4.0, t + 6.0)]
    host.append(("gen.stem", 99.0, 101.0))      # outlasts the slice
    return trace.Trace(wall_s=1e-4, window=(0.0, 100.0), device=device,
                       host=host)


def _ctx(tr, fwd=2, bwd=2, fwd_only=0, logs=None):
    launches = ([resnet_counts.norm_launch(2, 64, 64, 256)] * 2
                + [resnet_counts.norm_launch(2, 64, 64, 256, True)] * 2)
    return {"kind": "train", "trace": tr, "norm_launches": launches,
            "counters": {"instance_norm_fwd": fwd, "instance_norm_bwd": bwd,
                         "instance_norm_fwd_only": fwd_only},
            "device_name": H100, "flops_per_step": 17.4e12,
            "window": {"steps": 48, "wall_s": 6.0},
            "log": (logs.append if logs is not None else lambda m: None)}


def _reader(tiny, name):
    cell = harness.load_cell(tiny, CELL)
    assert name in {m["name"] for m in cell.per_layer}
    return harness.reader(cell, name)


def test_norm_roofline_reads_the_bound_over_the_kernels_time(tiny):
    r = _reader(tiny, "norm_roofline.resnet")
    ctx = _ctx(_trace())
    bound = sum(x.bytes for x in ctx["norm_launches"]) / 3.35e12
    assert r.read(ctx) == pytest.approx(100.0 * bound / 20e-6)


@pytest.mark.parametrize("what", ["counter", "trace", "fwd_only"])
def test_norm_roofline_reads_nothing_where_the_counts_disagree(tiny, what):
    r = _reader(tiny, "norm_roofline.resnet")
    logs = []
    if what == "counter":
        ctx = _ctx(_trace(), fwd=3, logs=logs)
    elif what == "trace":
        ctx = _ctx(_trace(bwd=1), logs=logs)
    else:
        ctx = _ctx(_trace(), fwd_only=1, logs=logs)
    assert r.read(ctx) is None
    assert logs and logs[0].startswith("norm_roofline")
    assert r.read(dict(ctx, device_name="cpu")) is None


def test_mfu_and_device_idle(tiny):
    ctx = _ctx(_trace())
    assert _reader(tiny, "mfu.resnet").read(ctx) == pytest.approx(
        100.0 * 17.4e12 * 8 / 989e12)
    assert _reader(tiny, "mfu.resnet").read(dict(ctx, kind="rollout")) is None
    # busy: 2 x 4 + 2 x 6 + 5 of the slice's 100 us
    assert _reader(tiny, "device_idle.resnet").read(ctx) == pytest.approx(
        75.0)


def test_gen_forward_ms_reads_whole_forwards(tiny):
    r = _reader(tiny, "gen_forward_ms.resnet")
    assert r.read(_ctx(_trace())) == pytest.approx(6e-3)
    logs = []
    tr = _trace()
    tr.host = [h for h in tr.host if not (h[0] == "gen.up" and h[1] > 30)]
    assert r.read(_ctx(tr, logs=logs)) is None
    assert logs and logs[0].startswith("gen_forward_ms")
    assert r.read(_ctx(_trace(spans=0), logs=logs)) is None


# ---- the check --------------------------------------------------------------

def test_the_port_in_float32_passes_its_check(tiny_resnet):
    out = run(tiny_resnet)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def _unbiased(x, eps):
    from video_layout_generation_tpu_torch.ops.kernels import instance_norm
    xf = x.to(instance_norm._stat_dtype(x))
    xc = xf - xf.mean(dim=(1, 2), keepdim=True)
    n = x.shape[1] * x.shape[2]
    rstd = torch.rsqrt((xc * xc).sum(dim=(1, 2), keepdim=True) / (n - 1)
                       + eps)
    return (xc * rstd).to(x.dtype), rstd[:, 0, 0, :]


@pytest.mark.parametrize("fault", ["unbiased_variance", "no_epsilon"])
def test_an_instance_norm_planted_wrong(tiny_resnet, fault, monkeypatch):
    from video_layout_generation_tpu_torch.ops.kernels import instance_norm
    real = instance_norm._forward_plain
    monkeypatch.setattr(
        instance_norm, "_forward_plain",
        _unbiased if fault == "unbiased_variance"
        else (lambda x, eps: real(x, 0.0)))
    out = run(tiny_resnet)
    assert out["correct"] is False
    grad = out["checks"]["worst_grad_gap"]
    assert grad["value"] > grad["limit"]


def test_a_step_that_returns_its_state_unchanged(tiny_resnet, monkeypatch):
    from video_layout_generation_tpu_torch.train import state
    monkeypatch.setattr(state.TrainState, "apply_gradients",
                        lambda self, grads: self)
    out = run(tiny_resnet)
    assert out["correct"] is False
    assert out["checks"]["median_change_gap"]["value"] > 0.5


def test_half_of_the_batch_left_out(tiny_resnet, monkeypatch):
    from video_layout_generation_tpu_torch.train import steps
    real = steps.decode_batch
    monkeypatch.setattr(steps, "decode_batch", lambda batch: real(
        {k: v[:v.shape[0] // 2] for k, v in batch.items()}))
    assert run(tiny_resnet)["correct"] is False


def test_the_float8_control_and_half_batch_fail(tiny_resnet):
    import sys
    sys.path.insert(0, str(ROOT / "benchmark"))
    import control
    cell = harness.load_cell(tiny_resnet, CELL)
    mod = harness.driver_module(cell)
    drv = mod.Driver(cell, SEED, "cpu")
    drv.setup()
    drv.release()
    got = control.train_readings(drv, mod)
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    assert any(v > cell.limits[k] for k, v in got["control"].items())
    assert any(v > cell.limits[k] for k, v in got["half_batch"].items())
