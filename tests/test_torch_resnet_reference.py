"""The port's ResnetGenerator and its train step on the CPU in float32
against the benchmark's plain reference (``benchmark/reference/
resnet_gen.py``, written from the published net, not from the port).

The step runs a narrow generator (ngf 8, 2 blocks, 32 px, batch 2) with
HED edges, every kernel's plain version and seeded random weights (the
generator's drawn as pix2pix initializes it, HED's and VGG19's as the
benchmark draws them); the forward alone runs the published 9 blocks. No
module of JAX or of the JAX package is imported.
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

from benchmark import resnet_weights, scenes  # noqa: E402
from benchmark.reference import resnet_gen, train as ref  # noqa: E402
from video_layout_generation_tpu_torch.losses import CombinedLoss  # noqa
from video_layout_generation_tpu_torch.models import (HNED,  # noqa: E402
                                                      ResnetGenerator)
from video_layout_generation_tpu_torch.ops import kernels  # noqa: E402
from video_layout_generation_tpu_torch.train import state as tstate  # noqa
from video_layout_generation_tpu_torch.train import steps as tsteps  # noqa

HW = (32, 32)
W = (40.0, 20.0, 10.0)
LR, B1 = 2e-4, 0.5
CONFIG = dict(n_channels=10, ngf=8, n_blocks=2, img_out=3, seg_out=20,
              init_gain=0.02)


def _port_generator(config, w):
    g = ResnetGenerator(input_nc=config["n_channels"], ngf=config["ngf"],
                        n_blocks=config["n_blocks"], norm="instance")
    g.load_state_dict(w, strict=True)
    return g


def _dead_biases(config):
    """Biases of convs followed by a non-affine InstanceNorm: the norm
    takes away each channel's mean, so their gradients vanish in exact
    arithmetic and both sides compute round-off."""
    return {n for n, _, kind in resnet_gen.spec_of(config)
            if kind == "bias" and not n.startswith("last_conv_")}


def test_the_reference_forward_equals_the_port_at_9_blocks():
    config = dict(CONFIG, n_blocks=9)
    w = resnet_weights.generator(config, 5, "cpu")
    # kernels of 0.02 leave the residual stream of 9 blocks dominated by
    # its input; larger kernels make every block count
    w = {k: v * 5.0 for k, v in w.items()}
    for k in w:
        if k.endswith(".bias"):
            w[k] = 0.1 * torch.randn(w[k].shape,
                                     generator=torch.Generator().manual_seed(
                                         len(k)))
    x = torch.randn(2, 32, 32, 10, generator=torch.Generator().manual_seed(3))
    seg, img = resnet_gen.generator(w, x)
    with torch.no_grad(), kernels.plain():
        pseg, pimg = _port_generator(config, w)(x)
    # float32 on both sides, the same operations in another order (NHWC
    # against NCHW convs, the norm's statistics): 1e-4 of the logits' size
    scale = float(seg.abs().max())
    torch.testing.assert_close(seg.permute(0, 2, 3, 1), pseg,
                               atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(img.permute(0, 2, 3, 1), pimg, atol=1e-5,
                               rtol=0)


def test_the_transposed_conv_is_flax_s_dilate_pad_correlate():
    """The reference's transposed conv against its definition: the input
    dilated by 2, padded (1, 2) and correlated with the kernel unflipped."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 4, 5, 6, generator=g)
    k = torch.randn(3, 3, 4, 7, generator=g)
    b = torch.randn(7, generator=g)
    got = resnet_gen._Gen({"t.kernel": k, "t.bias": b}).conv_transpose(x, "t")
    d = torch.zeros(1, 4, 9, 11)
    d[:, :, ::2, ::2] = x
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(d, (1, 2, 1, 2)), k.permute(3, 2, 0, 1), b)
    assert got.shape == (1, 7, 10, 12)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _coin_seed(coin: bool) -> int:
    for s in range(100):
        if bool(torch.rand((), generator=torch.Generator().manual_seed(s))
                < 0.5) == coin:
            return s
    raise AssertionError("no seed")


def _inputs():
    w = resnet_weights.for_config(
        dict(CONFIG, weights={"hned_scale": {"score*.kernel": 0.0141}}), 7,
        "cpu")
    imgs, segs = scenes.render(7, 2, 3, HW, 20, device="cpu")
    return w, imgs, segs


def _port_step(w, imgs, segs, coin):
    """The port's train step on the generator of ``w``, its state, and
    the batch of ``imgs`` and ``segs`` as the loader hands it over; call
    the step under ``kernels.plain()``."""
    gen = _port_generator(CONFIG, w["gen"])
    hned = HNED()
    hned.load_state_dict(w["hned"], strict=True)
    combined = CombinedLoss.create(device="cpu")
    combined.vgg_model.load_state_dict(w["vgg"], strict=True)
    state = tstate.TrainState.create(gen, tstate.make_optimizer("adam", LR,
                                                                B1))
    step = tsteps.make_train_step(
        gen, hned, combined, w_l1=W[0], w_style=W[1], w_seg=W[2],
        device="cpu",
        generator=torch.Generator().manual_seed(_coin_seed(coin)))
    batch = {"img1": imgs[:, 0], "img2": imgs[:, 1], "img3": imgs[:, 2],
             "seg1": segs[:, 0][..., None], "seg2": segs[:, 1][..., None],
             "seg3": segs[:, 2]}
    return step, state, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("coin", [False, True])
def test_one_train_step_against_the_reference(coin):
    w, imgs, segs = _inputs()
    step, state, batch = _port_step(w, imgs, segs, coin)
    with kernels.plain():
        state, metrics = step(state, batch)
    grads = {k: m / (1 - B1) for k, m in state.opt_state["mu"].items()}

    params = {k: v.clone().requires_grad_(True) for k, v in w["gen"].items()}
    nt = resnet_gen.Nets(params, w["hned"], w["vgg"])
    im = torch.from_numpy(imgs).float() / 255.0
    sg = torch.from_numpy(segs).long()
    terms, g_ref = ref.loss_and_grads(
        params, lambda rows: ref.triplet_loss(nt, im[rows], sg[rows], coin,
                                              W), 2, 2)
    ref.Adam(params, LR, B1).step(params, g_ref)

    # float32 on both sides: the terms read equal; 1e-5 of their size
    got = [float(metrics[k]) for k in ("loss_l1", "loss_style", "loss_seg")]
    assert got == pytest.approx(terms, rel=1e-5)

    dead = _dead_biases(CONFIG)
    g_max = max(float(g.abs().max()) for k, g in g_ref.items()
                if k not in dead)
    assert set(grads) == set(g_ref)
    for k, g in g_ref.items():
        if k in dead:
            # round-off on both sides, far under any live gradient
            assert float(grads[k].abs().max()) < 1e-4 * g_max, k
            assert float(g.abs().max()) < 1e-4 * g_max, k
            continue
        # the same sums in another order (read: 1e-5 of the leaf's
        # largest); 1e-3 of it
        torch.testing.assert_close(grads[k], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()),
                                   msg=k)
    for k, p in params.items():
        moved = state.params[k].detach() - w["gen"][k]
        if k in dead:
            # Adam's first step moves an element by lr * g / (|g| + eps):
            # a round-off gradient moves it by up to lr, either way
            assert float(moved.abs().max()) <= LR * (1 + 1e-5), k
            continue
        # lr towards the gradient's sign, which the sides share but where
        # an element's gradient is round-off of a sum that cancels
        torch.testing.assert_close(state.params[k], p, rtol=0,
                                   atol=LR / 2, msg=k)


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
    assert "video_layout_generation_tpu_torch" in loaded
    assert "benchmark" in loaded


def test_the_generator_s_spans_lie_inside_the_step_s_forward(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    w, imgs, segs = _inputs()
    step, state, batch = _port_step(w, imgs, segs, False)
    with profile(activities=[ProfilerActivity.CPU]) as prof, kernels.plain():
        step(state, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in
                   json.loads(path.read_text())["traceEvents"]
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    (fwd,) = [s for s in spans if s[2] == "step.forward"]
    gen = [s for s in spans if s[2].startswith("gen.")]
    assert [s[2] for s in gen] == ["gen.stem", "gen.blocks", "gen.up"]
    assert all(fwd[0] <= s[0] and s[1] <= fwd[1] for s in gen)
    assert all(a[1] <= b[0] for a, b in zip(gen, gen[1:]))
