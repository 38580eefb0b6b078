"""The cell ``resnet9_gan_b32`` on the CPU: the work its counts give the
discriminator's InstanceNorm launches and a GAN step, its four per-layer
readers on hand-built traces, and its check, which passes the port's
float32 path and fails the float8 control, half the batch, a state left
unchanged and each planted GAN fault, at a small size.

The tiny tree of ``conftest`` cuts every cell of BENCHMARK.json; this
module gives it the traffic of the ``train_gan`` and ``train_resnet``
drivers (the train cells' tiny settings) and tiny limits for the
discriminator's numbers; the GAN cell gets the generator at ngf 8, the
discriminator at ndf 8 and limits of its own, set from float32 readings
at that size (below)."""

import json
import time
from pathlib import Path

import pytest
import torch

import conftest
from benchmark import harness, trace
from benchmark.reference import (counts, gan_counts, resnet_counts,
                                 resnet_gan)

# every cell of the tiny tree needs its driver's tiny traffic, so that this
# module also runs alone
for driver in ("train_resnet", "train_gan"):
    conftest.TINY_TRAFFIC.setdefault(driver, conftest.TINY_TRAFFIC["train"])
conftest.TINY_LIMITS.setdefault("worst_disc_grad_gap", 1e-4)
conftest.TINY_LIMITS.setdefault("median_disc_change_gap", 2e-3)

ROOT = Path(__file__).resolve().parents[2]
CELL = "resnet9_gan_b32"
SEED = 2 ** 31 + 11
H100 = "NVIDIA H100 80GB HBM3"
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "resnet9_gan_edge.json").read_text())
# the port's float32 path against the float32 reference at ngf 8, ndf 8,
# 32 px reads up to 6.7e-5 in G's gradient gap, 6.8e-4 in G's median
# change, 4.5e-7 in D's gradient gap and 1.9e-4 in D's median change on
# four seeds. The faults' smallest readings there: G's adversarial term
# against D before its update 0.021 in G's gradient gap; lsgan's targets
# swapped 0.038 in G's and 0.084 in D's; the float8 control 0.058 and
# 0.059; half the batch 0.43 and 0.21
TINY_LIMITS = {"worst_grad_gap": 3e-4, "worst_tensor_grad_gap": 3e-4,
               "median_change_gap": 5e-3, "worst_disc_grad_gap": 1e-4,
               "median_disc_change_gap": 2e-3}


@pytest.fixture
def tiny_gan(tiny):
    bench = tiny / "benchmark"
    path = bench / "configs" / "resnet9_gan_edge.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), ngf=8,
                                    ndf=8)))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return tiny


def run(tiny, trace_it=False):
    return harness.run_cell(tiny, CELL, SEED, 0.3, trace_it, time.time(),
                            "cpu", log=lambda m: None)


# ---- counts -----------------------------------------------------------------

def test_the_norms_of_a_gan_step_at_the_published_widths():
    shapes = gan_counts.disc_forward_shapes(CONFIG, 32)
    assert shapes == [(32, 64, 64, 128), (32, 32, 32, 256),
                      (32, 31, 31, 512)]
    launches = gan_counts.step_norm_launches(CONFIG, {"batch": 32})
    assert [x.kind for x in launches] == ["norm_fwd"] * 32 + ["norm_bwd"] * 32
    g = resnet_counts.step_norm_launches(CONFIG, {"batch": 32})
    # D's 3 forwards a step, 3 norms each, one forward and one backward
    elems = sum(n * h * w * c for n, h, w, c in shapes)
    assert sum(x.bytes for x in launches) - sum(x.bytes for x in g) == (
        3 * (5 * 2 * elems + 2 * 32 * (128 + 256 + 512) * 4))


def test_the_discriminator_s_model_flops_are_its_convs():
    """FlopCounterMode over the reference's PatchGAN equals 2 x the
    multiply-adds of its 5 convs at 256 x 256: 4 x 4 kernels, 128², 64²
    and 32² after the stride-2 convs, 31² and 30² after the others."""
    disc = counts.meta_params(resnet_gan.disc_spec_of(CONFIG))
    x = torch.empty((1, 9, 256, 256), device="meta")
    got = counts.model_flops(lambda: resnet_gan.discriminator(disc, x))
    macs = 16 * (128 ** 2 * 9 * 64 + 64 ** 2 * 64 * 128
                 + 32 ** 2 * 128 * 256 + 31 ** 2 * 256 * 512
                 + 30 ** 2 * 512 * 1)
    assert got == 2 * macs


def test_a_gan_step_adds_the_discriminator_s_work_to_the_train_step():
    """Three D forwards (F each), D's weight gradients of two (2F) and the
    data gradients of all three (3F), less the first conv's input gradient
    of the two whose input holds no gradient: 8F - 2 f0 on top of the
    ResNet-9 train step's FLOPs."""
    traffic = {"batch": 2}
    hw = CONFIG["image_hw"]
    disc = counts.meta_params(resnet_gan.disc_spec_of(CONFIG))
    x = torch.empty((2, 9) + tuple(hw), device="meta")
    f = counts.model_flops(lambda: resnet_gan.discriminator(disc, x))
    f0 = 2 * 2 * 128 ** 2 * 16 * 9 * 64
    assert (gan_counts.step_flops(CONFIG, traffic)
            - resnet_counts.step_flops(CONFIG, traffic)) == 8 * f - 2 * f0


def test_roles_refuse_a_step_they_do_not_count():
    assert gan_counts.roles(CONFIG) == ("fake", "real", "adv")
    with pytest.raises(ValueError):
        gan_counts.roles(dict(CONFIG, gan_mode="wgangp"))


# ---- the readers ------------------------------------------------------------

def _trace(fwd=2, bwd=2, steps=2, drop=None):
    device = ([("void instance_norm_fwd_kernel<__nv_bfloat16, 8>", 10.0 * i,
                10.0 * i + 4.0) for i in range(fwd)]
              + [("void instance_norm_bwd_kernel<__nv_bfloat16, 8>",
                  50.0 + 10.0 * i, 56.0 + 10.0 * i) for i in range(bwd)]
              + [("sm90_xmma_conv", 90.0, 95.0)])
    host = [("bench.slice", 0.0, 100.0)]
    for i in range(steps):
        t = 40.0 * i
        host += [(n, s, e) for n, s, e in
                 (("gan.disc", t, t + 2.0),
                  ("gan.disc_update", t + 2.0, t + 3.0),
                  ("gan.adv", t + 3.0, t + 6.0)) if (n, i) != drop]
    host.append(("gan.disc", 99.0, 101.0))      # outlasts the slice
    return trace.Trace(wall_s=1e-4, window=(0.0, 100.0), device=device,
                       host=host)


def _ctx(tr, fwd=2, bwd=2, forwards="sound", logs=None):
    launches = ([resnet_counts.norm_launch(2, 31, 31, 512)] * 2
                + [resnet_counts.norm_launch(2, 31, 31, 512, True)] * 2)
    counted = {"fake": 24, "real": 24, "adv": 24, "penalty": 0}
    if forwards == "extra":
        counted["adv"] = 48
    return {"kind": "train", "trace": tr, "norm_launches": launches,
            "counters": {"instance_norm_fwd": fwd, "instance_norm_bwd": bwd,
                         "instance_norm_fwd_only": 0},
            "disc_forwards": None if forwards == "none" else counted,
            "epoch_steps": 24, "disc_roles": ("fake", "real", "adv"),
            "device_name": H100, "flops_per_step": 19.09e12,
            "window": {"steps": 48, "wall_s": 6.0},
            "log": (logs.append if logs is not None else lambda m: None)}


def _reader(tiny, name):
    cell = harness.load_cell(tiny, CELL)
    assert name in {m["name"] for m in cell.per_layer}
    return harness.reader(cell, name)


def test_norm_roofline_reads_the_bound_over_the_kernels_time(tiny):
    r = _reader(tiny, "norm_roofline.gan")
    ctx = _ctx(_trace())
    bound = sum(x.bytes for x in ctx["norm_launches"]) / 3.35e12
    assert r.read(ctx) == pytest.approx(100.0 * bound / 20e-6)


@pytest.mark.parametrize("what", ["counter", "trace", "extra", "none"])
def test_norm_roofline_reads_nothing_where_the_counts_disagree(tiny, what):
    r = _reader(tiny, "norm_roofline.gan")
    logs = []
    if what == "counter":
        ctx = _ctx(_trace(), fwd=3, logs=logs)
    elif what == "trace":
        ctx = _ctx(_trace(bwd=1), logs=logs)
    else:
        ctx = _ctx(_trace(), forwards=what, logs=logs)
    assert r.read(ctx) is None
    assert logs and logs[0].startswith("norm_roofline")


def test_mfu_and_device_idle(tiny):
    ctx = _ctx(_trace())
    assert _reader(tiny, "mfu.gan").read(ctx) == pytest.approx(
        100.0 * 19.09e12 * 8 / 989e12)
    assert _reader(tiny, "mfu.gan").read(dict(ctx, device_name="cpu")) is None
    # busy: 2 x 4 + 2 x 6 + 5 of the slice's 100 us
    assert _reader(tiny, "device_idle.gan").read(ctx) == pytest.approx(75.0)


def test_disc_ms_reads_whole_steps(tiny):
    r = _reader(tiny, "disc_ms.gan")
    assert r.read(_ctx(_trace())) == pytest.approx(6e-3)
    logs = []
    tr = _trace(drop=("gan.adv", 1))
    assert r.read(_ctx(tr, logs=logs)) is None
    assert logs and logs[0].startswith("disc_ms")
    assert r.read(_ctx(_trace(steps=0), logs=logs)) is None


# ---- the check --------------------------------------------------------------

def test_the_port_in_float32_passes_its_check(tiny_gan):
    out = run(tiny_gan)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(TINY_LIMITS)
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_a_traced_run_reads_the_step_s_spans(tiny_gan):
    out = run(tiny_gan, trace_it=True)
    assert out["correct"] is True, out["checks"]
    # the CPU has no peaks, so the roofline and the mfu read nothing
    assert set(out["metrics"]) == {"disc_ms.gan", "device_idle.gan"}
    assert out["metrics"]["disc_ms.gan"]["value"] > 0


def _failed(out, *numbers):
    assert out["correct"] is False
    return [k for k in numbers
            if out["checks"][k]["value"] > out["checks"][k]["limit"]]


def test_the_adversarial_term_against_d_before_its_update(tiny_gan,
                                                          monkeypatch):
    """G's step sees D as it was before D's update: D's update waits
    until G's gradients are taken."""
    from video_layout_generation_tpu_torch.models import NLayerDiscriminator
    from video_layout_generation_tpu_torch.train import state
    real, pending = state.TrainState.apply_gradients, []

    def deferred(self, grads):
        if isinstance(self.module, NLayerDiscriminator):
            pending.append((self, grads))
            return self
        while pending:
            real(*pending.pop())
        return real(self, grads)
    monkeypatch.setattr(state.TrainState, "apply_gradients", deferred)
    assert _failed(run(tiny_gan), "worst_grad_gap") == ["worst_grad_gap"]


def test_lsgan_s_targets_swapped(tiny_gan, monkeypatch):
    from video_layout_generation_tpu_torch.train import gan
    real = gan.gan_loss
    monkeypatch.setattr(gan, "gan_loss",
                        lambda pred, is_real, mode: real(pred, not is_real,
                                                         mode))
    assert _failed(run(tiny_gan), "worst_grad_gap",
                   "worst_disc_grad_gap") == ["worst_grad_gap",
                                              "worst_disc_grad_gap"]


def test_a_step_that_leaves_d_unchanged(tiny_gan, monkeypatch):
    from video_layout_generation_tpu_torch.models import NLayerDiscriminator
    from video_layout_generation_tpu_torch.train import state
    real = state.TrainState.apply_gradients
    monkeypatch.setattr(
        state.TrainState, "apply_gradients",
        lambda self, grads: (self if isinstance(self.module,
                                                NLayerDiscriminator)
                             else real(self, grads)))
    out = run(tiny_gan)
    assert out["correct"] is False
    assert out["checks"]["median_disc_change_gap"]["value"] > 0.5


def test_half_of_the_batch_left_out(tiny_gan, monkeypatch):
    from video_layout_generation_tpu_torch.train import gan
    real = gan.decode_batch
    monkeypatch.setattr(gan, "decode_batch", lambda batch: real(
        {k: v[:v.shape[0] // 2] for k, v in batch.items()}))
    assert run(tiny_gan)["correct"] is False


def test_the_float8_control_half_batch_and_faults_fail(tiny_gan):
    import sys
    sys.path.insert(0, str(ROOT / "benchmark"))
    import control
    cell = harness.load_cell(tiny_gan, CELL)
    mod = harness.driver_module(cell)
    drv = mod.Driver(cell, SEED, "cpu")
    drv.setup()
    drv.release()
    got = control.train_readings(drv, mod)
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    for name in ("control", "half_batch"):
        assert any(v > cell.limits[k] for k, v in got[name].items()), name
    ref = got["raw"]["reference"]
    for fault in resnet_gan.FAULTS:
        res = mod.compare(drv.follow(fault=fault), ref, drv.sizes)
        assert res["worst_grad_gap"] > cell.limits["worst_grad_gap"], fault
