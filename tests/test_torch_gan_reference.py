"""The port's GAN step (``train/gan.py``) on the CPU in float32 against the
benchmark's plain reference (``benchmark/reference/resnet_gan.py``, written
from the published nets and step, not from the port).

Three steps of a narrow ResNet generator (ngf 8, 2 blocks) against a
narrow PatchGAN (ndf 8), 32 px, batch 2, HED edges, no flip, every
kernel's plain version and seeded random weights (both nets drawn as
pix2pix initializes them, HED's and VGG19's as the benchmark draws them),
in lsgan and vanilla; the discriminator's forward alone at its published
ndf 64 and 256 px; the step's spans under a profiler and its count of D
forwards. No module of JAX or of the JAX package is imported.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import gan_weights, scenes  # noqa: E402
from benchmark.reference import resnet_gan, resnet_gen  # noqa: E402
from video_layout_generation_tpu_torch.losses import CombinedLoss  # noqa
from video_layout_generation_tpu_torch.models import (  # noqa: E402
    HNED, NLayerDiscriminator, ResnetGenerator)
from video_layout_generation_tpu_torch.ops import kernels  # noqa: E402
from video_layout_generation_tpu_torch.train import gan as tgan  # noqa
from video_layout_generation_tpu_torch.train import state as tstate  # noqa

HW = (32, 32)
W = (40.0, 20.0, 10.0)
LR, B1 = 2e-4, 0.5
STEPS, BATCH = 3, 2
CONFIG = dict(n_channels=10, ngf=8, n_blocks=2, img_out=3, seg_out=20,
              init_gain=0.02, disc_input_nc=9, ndf=8, n_layers_D=3,
              disc_init_gain=0.02,
              weights={"hned_scale": {"score*.kernel": 0.0141}})
STEP_SPANS = ["step.inputs", "step.forward", "gan.disc", "gan.disc_update",
              "gan.adv", "step.backward", "step.update"]
TERMS = ("loss_gan", "loss_l1", "loss_style", "loss_seg")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dead_biases(spec, heads=("last_conv_",)):
    """Biases of convs followed by a non-affine InstanceNorm: the norm
    takes away each channel's mean, so their gradients vanish in exact
    arithmetic and both sides compute round-off."""
    return {n for n, _, kind in spec if kind == "bias"
            and not n.startswith(heads)}


DEAD = {"gen": _dead_biases(resnet_gen.spec_of(CONFIG)),
        "disc": _dead_biases(resnet_gan.disc_spec_of(CONFIG),
                             ("Conv_0.", "Conv_4."))}


def _weights():
    w = gan_weights.for_config(CONFIG, 7, "cpu")
    imgs, segs = scenes.render(7, STEPS * BATCH, 3, HW, 20, device="cpu")
    return w, imgs, segs


def _port(w, mode):
    gen = ResnetGenerator(input_nc=10, ngf=8, n_blocks=2, norm="instance")
    gen.load_state_dict(w["gen"], strict=True)
    disc = NLayerDiscriminator(9, 8, n_layers=3, norm="instance")
    disc.load_state_dict(w["disc"], strict=True)
    hned = HNED()
    hned.load_state_dict(w["hned"], strict=True)
    combined = CombinedLoss.create(device="cpu")
    combined.vgg_model.load_state_dict(w["vgg"], strict=True)
    st = tgan.GanTrainState(
        gen=tstate.TrainState.create(gen, tstate.make_optimizer("adam", LR,
                                                                B1)),
        disc=tstate.TrainState.create(disc, tstate.make_optimizer("adam", LR,
                                                                  B1)))
    step = tgan.make_gan_train_step(gen, disc, hned, combined, mode,
                                    w_l1=W[0], w_style=W[1], w_seg=W[2],
                                    flip_mode="none", device="cpu")
    return step, st


def _batch(imgs, segs, s):
    rows = slice(s * BATCH, (s + 1) * BATCH)
    b = {"img1": imgs[rows, 0], "img2": imgs[rows, 1], "img3": imgs[rows, 2],
         "seg1": segs[rows, 0][..., None], "seg2": segs[rows, 1][..., None],
         "seg3": segs[rows, 2]}
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=["lsgan", "vanilla"])
def both(request):
    """Both sides' three steps: the port's metrics each step, its first
    gradients (Adam's first moment after step 1 over 1 - beta1) and its
    parameters after step 3; the reference's terms, gradients and
    parameters."""
    mode = request.param
    w, imgs, segs = _weights()
    step, st = _port(w, mode)
    port = {"metrics": []}
    with kernels.plain():
        for s in range(STEPS):
            st, m = step(st, _batch(imgs, segs, s))
            port["metrics"].append({k: float(v) for k, v in m.items()})
            if s == 0:
                port["grads"] = {
                    net: {k: mu / (1 - B1) for k, mu in
                          getattr(st, net).opt_state["mu"].items()}
                    for net in ("gen", "disc")}
    port["params"] = {net: {k: v.detach().clone() for k, v in
                            getattr(st, net).params.items()}
                      for net in ("gen", "disc")}
    port["disc_forwards"] = dict(step.disc_forwards)
    batches = [{"imgs": torch.from_numpy(imgs[s * BATCH:(s + 1) * BATCH])
                .float() / 255.0,
                "segs": torch.from_numpy(segs[s * BATCH:(s + 1) * BATCH])
                .long(), "coin": False, "n": BATCH} for s in range(STEPS)]
    ref = {"terms": [], "d_loss": []}
    for s, got in enumerate(resnet_gan.steps(
            w["gen"], w["disc"], w["hned"], w["vgg"], batches, LR, B1,
            BATCH, mode, W)):
        ref["terms"].append(got["g_terms"])
        ref["d_loss"].append(got["d_loss"])
        if s == 0:
            ref["grads"] = {net: {k: g.clone() for k, g in grads.items()}
                            for net, grads in got["grads"].items()}
    ref["params"] = {net: {k: v.detach().clone() for k, v in p.items()}
                     for net, p in got["params"].items()}
    return mode, w, port, ref


def test_each_step_s_losses_against_the_reference(both):
    _, _, port, ref = both
    for m, terms, d in zip(port["metrics"], ref["terms"], ref["d_loss"]):
        # float32 on both sides, the same sums in another order
        assert [m[k] for k in TERMS] == pytest.approx(terms, rel=1e-5)
        assert m["loss"] == pytest.approx(sum(terms), rel=1e-5)
        assert m["loss_d"] == pytest.approx(d, rel=1e-5)
        assert m["loss_d"] == pytest.approx(
            0.5 * (m["loss_d_fake"] + m["loss_d_real"]), rel=1e-6)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_both_nets_gradients_after_step_1(both, net):
    _, _, port, ref = both
    got, want = port["grads"][net], ref["grads"][net]
    assert set(got) == set(want)
    live = max(float(g.abs().max()) for k, g in want.items()
               if k not in DEAD[net])
    for k, g in want.items():
        if k in DEAD[net]:
            # round-off on both sides, far under any live gradient
            assert float(got[k].abs().max()) < 1e-4 * live, k
            assert float(g.abs().max()) < 1e-4 * live, k
            continue
        # the same sums in another order: 1e-3 of the leaf's largest
        torch.testing.assert_close(got[k], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()), msg=k)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_both_nets_parameters_after_step_3(both, net):
    _, w, port, ref = both
    got, want = port["params"][net], ref["params"][net]
    for k, p in want.items():
        moved = got[k] - w[net][k]
        if k in DEAD[net]:
            # where its gradient is round-off, Adam moves an element by
            # about lr a step either way (a little more where the sign
            # turns)
            assert float(moved.abs().max()) <= 2 * STEPS * LR, k
            continue
        # each step moves an element by about lr towards its gradient's
        # sign, which the sides share but where an element's gradient is
        # round-off of a sum that cancels
        torch.testing.assert_close(got[k], p, rtol=0, atol=LR, msg=k)
        assert float(moved.norm()) > 0, k


def test_the_step_counts_two_plus_one_d_forwards_a_step(both):
    _, _, port, _ = both
    assert port["disc_forwards"] == {"fake": STEPS, "real": STEPS,
                                     "adv": STEPS, "penalty": 0}


def test_the_discriminator_forward_at_ndf_64_and_256_px():
    config = dict(CONFIG, ndf=64)
    w = gan_weights.discriminator(config, 5, "cpu")
    # kernels of 0.02 leave the patch logits of order 1e-2 and round-off
    # of the norms' statistics a large share; larger kernels and biases
    # make every conv count
    w = {k: v * 25.0 if k.endswith(".kernel")
         else 0.1 * torch.randn(v.shape, generator=torch.Generator()
                                .manual_seed(len(k)))
         for k, v in w.items()}
    disc = NLayerDiscriminator(9, 64, n_layers=3, norm="instance")
    disc.load_state_dict(w, strict=True)
    x = torch.randn(1, 256, 256, 9,
                    generator=torch.Generator().manual_seed(3))
    want = resnet_gan.discriminator(w, x.permute(0, 3, 1, 2))
    with torch.no_grad(), kernels.plain():
        got = disc(x)
    assert got.shape == (1, 30, 30, 1) and want.shape == (1, 1, 30, 30)
    # float32 on both sides, the same operations in another order (NHWC
    # against NCHW convs, the norm's statistics): 1e-4 of the logits' size
    torch.testing.assert_close(want.permute(0, 2, 3, 1), got, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_the_step_s_spans_nest_under_a_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    w, imgs, segs = _weights()
    step, st = _port(w, "lsgan")
    with profile(activities=[ProfilerActivity.CPU]) as prof, kernels.plain():
        step(st, _batch(imgs, segs, 0))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in
                   json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    top = [s for s in spans if s[2].startswith(("step.", "gan."))]
    assert [s[2] for s in top] == STEP_SPANS
    assert all(a[1] <= b[0] for a, b in zip(top, top[1:]))
    (fwd,) = [s for s in top if s[2] == "step.forward"]
    gen = [s for s in spans if s[2].startswith("gen.")]
    assert [s[2] for s in gen] == ["gen.stem", "gen.blocks", "gen.up"]
    assert all(fwd[0] <= s[0] and s[1] <= fwd[1] for s in gen)


def test_the_trainer_reports_an_epoch_s_d_forwards(tmp_path):
    from video_layout_generation_tpu_torch.config import Config
    from video_layout_generation_tpu_torch.train.trainer import Trainer
    cfg = Config(dataset="synthetic", synthetic_train_size=4,
                 synthetic_val_size=2, image_size=HW, batch_size=2,
                 epochs=1, arch="ResnetGenerator", ngf=8, gan_train=True,
                 ndf=8, compute_dtype="float32", workers=1, print_freq=1,
                 edge=False, path=str(tmp_path), device="cpu")
    t = Trainer(cfg)
    for epoch in range(2):
        t.set_epoch(epoch)
        t.train()
        assert {k: v for k, v in t.epoch_stats.items()
                if k.startswith("disc_forwards_")} == {
            "disc_forwards_fake": 2, "disc_forwards_real": 2,
            "disc_forwards_adv": 2, "disc_forwards_penalty": 0}
    log = (tmp_path / "experiment.log").read_text()
    assert log.count("D forwards fake 2 real 2 adv 2 penalty 0") == 2


def test_this_file_loads_no_jax():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {__file__!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "orbax",
                         "video_layout_generation_tpu"}
    assert {"video_layout_generation_tpu_torch", "benchmark"} <= loaded
