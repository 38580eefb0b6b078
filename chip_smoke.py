#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (video_layout_generation_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0]

Phases:
  1. print the card's name and power limit, build the CUDA kernels from
     ``video_layout_generation_tpu_torch/csrc`` with nvcc (sm_90a);
  2. kernels: hold kernel A (prelu_conv3x3, with and without its ReLU
     epilogue) and kernel B (fused_lateral) against their plain PyTorch
     versions in bf16 at the shapes of the rollout and at every conv shape
     of VGG19 and HNED (batch 16, 256x256), and time each beside its plain
     version, a cuDNN yardstick and its bound; hold the fused SSIM kernel
     (ssim_loss) against its plain version in f32 and bf16 at the
     validation step's shape and at a ragged one, once with x = y (loss
     exactly 0). Every time is device time from a torch.profiler trace;
  3. slice: LayoutPredictor at full width (8-channel GridNet, filters
     32/64/96, 256x256, 8 frames, batch 16, bf16, random weights from
     ``--seed`` passed through the flax weight bridge) answers 3 requests
     (full, padded, pipelined); the launch counts prove every conv went
     through the kernels; step 1 is held against the same predictor on the
     plain versions; rollout frames/s, batch-1 latency and a
     torch.profiler breakdown of one b16 request are printed;
  4. validation: the edge-mode validation step at full width (10-channel
     GridNet + HNED + VGG19 ``CombinedLoss.eval_variant()``, all bf16 with
     f32 loss islands, random weights from ``--seed`` through the weight
     bridges) runs ``validate`` over 3 uint8 ``packed6`` batches of 16; the
     launch counts of every step are asserted, the loss terms, layouts and
     frames are held against the same step on the plain versions (HNED
     alone, GridNet alone on one shared edge map, and end to end), and
     validation samples/s and a profile of one step are printed;
  5. edge rollout: ``LayoutPredictor(use_edges=True)`` (the same three
     nets) answers b16 requests of 8 frames; launch counts, step-1
     agreement with the plain versions, frames/s, batch-1 latency and a
     profile of one request are printed.

The launch counters are set to 0 just before each of the phases 3-5 and
read just after it; a kernel of a phase's path that was launched no time
fails the run. Any failure exits non-zero. The line before the last is the
``kernels`` JSON object; the last line is ``{"ok": true, "device": {...}}``. With no CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BATCH, HW, FRAMES, FILTERS = 16, (256, 256), 8, (32, 64, 96)
N_CLASSES = 20
VAL_BATCHES = 3
DEVICE = "cuda"
# Launches from the code: a GridNet forward is 31 A + 15 B, an HNED forward
# 13 A, a VGG19 forward to relu4_4 12 A.
LAUNCHES_PER_ROLLOUT = {"prelu_conv3x3": 31 * FRAMES,
                        "fused_lateral": 15 * FRAMES, "ssim_loss": 0}
# eval step: GridNet + HNED on frames 1 and 2 + VGG19 on output and target
LAUNCHES_PER_EVAL_STEP = {"prelu_conv3x3": 31 + 2 * 13 + 2 * 12,
                          "fused_lateral": 15, "ssim_loss": 1}
# edge rollout: per frame GridNet + HNED, plus HNED on the two seed frames
LAUNCHES_PER_EDGE_ROLLOUT = {"prelu_conv3x3": (31 + 13) * FRAMES + 2 * 13,
                             "fused_lateral": 15 * FRAMES, "ssim_loss": 0}
SSIM_PLANE_TOL = 1e-5   # max |kernel - plain| per plane; values in [0, 1]
LOSS_TERM_RTOL = 2e-2   # kernel path vs plain path, bf16 nets
# Edge-mode frames, kernel path vs plain path. The max-norm limit of the
# no-edge phase (IMG_MAX_TOL of the largest value) is for nets that see
# identical inputs, and is held in edge mode too where GridNet gets one
# shared, plain HNED edge map. End to end the two edge channels come from
# HNED through the kernels, whose own bf16 differences (held under
# EDGE_MAP_TOL) move single pixels further: there the mean |difference|
# over mean |plain| is held, and the share of values within IMG_MAX_TOL.
IMG_MAX_TOL = 2e-2
EDGE_MAP_TOL = 2e-2      # HNED fused edge map in [0, 1], max abs
EDGE_IMG_MEAN_TOL = 1e-2
EDGE_IMG_SHARE = 0.999   # of the values within IMG_MAX_TOL of the maximum
ROUTES = {
    "prelu_conv3x3": dict(
        source="video_layout_generation_tpu_torch/csrc/conv3x3.cu",
        replaces=("video_layout_generation_tpu/ops/pallas/conv_packed.py:165; "
                  "video_layout_generation_tpu/ops/pallas/conv1x2.py:93; "
                  "video_layout_generation_tpu/ops/pallas/conv3x3.py:65"),
        main_case="A prelu row0"),
    "fused_lateral": dict(
        source="video_layout_generation_tpu_torch/csrc/lateral.cu",
        replaces="video_layout_generation_tpu/ops/pallas/conv_packed.py:308",
        main_case="B row0 +res"),
    "ssim_loss": dict(
        source="video_layout_generation_tpu_torch/csrc/ssim.cu",
        replaces="video_layout_generation_tpu/ops/pallas/ssim.py:62",
        main_case="SSIM f32 eval shape"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 20):
    """Mean device time per call of ``fn``: the summed time of every kernel
    and copy that ``reps`` calls put on the card, from a torch.profiler
    trace. Every ``ms``, ``plain_ms`` and ``library_ms`` of the script comes
    from here. Host time and the gaps between kernels are left out, so a
    kernel shorter than its wrapper's host path is timed as the card ran
    it."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if not ev.key.startswith(("aten::", "cuda", "Activity")))
    check(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / reps


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---- phase 2: kernels ------------------------------------------------------

def kernel_cases():
    """(kernel, name, shape (N, H, W, Ci), Co, stride, prelu, residual,
    relu_out, norm-error bound)."""
    r0, r1, r2 = ((BATCH, 256, 256), (BATCH, 128, 128), (BATCH, 64, 64))
    a = [
        ("A prelu row0", r0 + (32,), 32, 1, True, False),
        ("A prelu+res row0", r0 + (32,), 32, 1, True, True),
        ("A plain C64 128^2 (TPU conv1x2)", r1 + (64,), 64, 1, False, False),
        ("A plain C128 128^2 (TPU conv3x3)", r1 + (128,), 128, 1, False,
         False),
        ("A stride2 32->64", r0 + (32,), 64, 2, True, False),
        ("A input 8->32", r0 + (8,), 32, 1, True, False),
        ("A head 32->20", r0 + (32,), 20, 1, True, False),
    ]
    r3, r4 = (BATCH, 32, 32), (BATCH, 16, 16)
    # every conv -> ReLU shape of VGG19 (to relu4_4) and HNED (5 stages)
    relu = [
        ("A relu 3->64 256^2 (VGG/HNED conv1_1)", r0 + (3,), 64),
        ("A relu 64->64 256^2 (VGG/HNED conv1_2)", r0 + (64,), 64),
        ("A relu 64->128 128^2 (VGG/HNED conv2_1)", r1 + (64,), 128),
        ("A relu 128->128 128^2 (VGG/HNED conv2_2)", r1 + (128,), 128),
        ("A relu 128->256 64^2 (VGG/HNED conv3_1)", r2 + (128,), 256),
        ("A relu 256->256 64^2 (VGG/HNED stage 3)", r2 + (256,), 256),
        ("A relu 256->512 32^2 (VGG/HNED conv4_1)", r3 + (256,), 512),
        ("A relu 512->512 32^2 (VGG/HNED stage 4)", r3 + (512,), 512),
        ("A relu 512->512 16^2 (HNED stage 5)", r4 + (512,), 512),
    ]
    b = []
    for row, shp, c in (("row0", r0, 32), ("row1", r1, 64), ("row2", r2, 96)):
        b.append((f"B {row}", shp + (c,), c, 1, True, False))
        b.append((f"B {row} +res", shp + (c,), c, 1, True, True))
    return ([("prelu_conv3x3",) + x + (False, 1e-2) for x in a]
            + [("prelu_conv3x3",) + x + (1, False, False, True, 1e-2)
               for x in relu]
            + [("fused_lateral",) + x + (False, 2e-2) for x in b])


def run_kernel_case(torch, F, kern, case, seed):
    kernel, name, shape, co, stride, act, with_res, relu_out, tol = case
    n, h, w, ci = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    x = randn(n, h, w, ci)
    res = randn(n, ho, wo, co) if with_res else None
    alpha = torch.tensor(0.25, device=dev)
    if kernel == "prelu_conv3x3":
        wt = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = randn(co, scale=0.1, dtype=torch.float32)
        al = alpha if act else None
        args = (x, wt, bias, al, res, stride, relu_out)
        fn, plain = kern.prelu_conv3x3, kern.prelu_conv3x3_plain
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_cl = x.permute(0, 3, 1, 2)   # channels_last view, no copy

        def library():
            y = F.conv2d(x_cl, w_oihw, bias.to(x.dtype), stride=stride,
                         padding=1)
            return F.relu(y) if relu_out else y
        flops = 2 * n * ho * wo * co * 9 * ci
        nbytes = 2 * (x.numel() + wt.numel() + n * ho * wo * co
                      + (res.numel() if with_res else 0)) + 4 * co
    else:
        w0 = randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5)
        w1 = randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5)
        b0 = randn(ci, scale=0.1, dtype=torch.float32)
        b1 = randn(ci, scale=0.1, dtype=torch.float32)
        a1 = torch.tensor(0.1, device=dev)
        args = (x, w0, b0, alpha, w1, b1, a1, res)
        fn, plain = kern.fused_lateral, kern.fused_lateral_plain
        w0o = w0.permute(3, 2, 0, 1).contiguous()
        w1o = w1.permute(3, 2, 0, 1).contiguous()
        x_cl = x.permute(0, 3, 1, 2)

        def library():
            y = F.conv2d(x_cl, w0o, b0.to(x.dtype), padding=1)
            return F.conv2d(y, w1o, b1.to(x.dtype), padding=1)
        flops = 2 * 2 * n * h * w * ci * 9 * ci
        nbytes = 2 * (2 * x.numel() + w0.numel() + w1.numel()
                      + (res.numel() if with_res else 0)) + 8 * ci
    got = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    check(got.shape == (n, ho, wo, co) and got.dtype == torch.bfloat16,
          f"{name}: output {tuple(got.shape)} {got.dtype}")
    diff = (got.float() - ref.float()).abs()
    max_abs = float(diff.max())
    norm = max_abs / max(float(ref.float().abs().max()), 1e-30)
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    ms = device_ms(torch, lambda: fn(*args))
    plain_ms = device_ms(torch, lambda: plain(*args))
    library_ms = device_ms(torch, library)
    b_ms, b_by = bound(nbytes, flops)
    check(not relu_out or float(got.float().min()) == 0.0,
          f"{name}: the ReLU epilogue left a value below zero or none at 0")
    rec = dict(case=name, kernel=kernel, shape=list(shape), co=co,
               stride=stride, relu_out=relu_out, max_abs_err=max_abs,
               norm_err=norm,
               norm_err_bound=tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    check(norm <= tol, f"{name}: normalized error {norm:.3e} > {tol:.0e}")
    return rec


def ssim_cases():
    """(name, shape, dtype name, same: x == y)."""
    full = (BATCH,) + HW + (3,)
    return [("SSIM f32 eval shape", full, "float32", False),
            ("SSIM bf16 eval shape", full, "bfloat16", False),
            ("SSIM f32 ragged (5,130,94,3)", (5, 130, 94, 3), "float32",
             False),
            ("SSIM f32 x == y", full, "float32", True)]


def run_ssim_case(torch, kern, case, seed):
    """Hold the fused SSIM kernel against its plain version per plane and
    time both. The timed launches rotate over 4 input pairs (100 MB in f32
    at the eval shape) so that none finds its inputs in the 50 MB L2."""
    name, shape, dtype_name, same = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    pairs = []
    for _ in range(4):
        x = (torch.randn(shape, generator=g, device=dev) * 0.2
             + 0.5).clamp(0, 1)
        y = x if same else (x + 0.1 * torch.randn(
            shape, generator=g, device=dev)).clamp(0, 1)
        pairs.append((x.to(dtype), y.to(dtype).clone()))
    x, y = pairs[0]
    got = kern.ssim_planes(x, y)
    again = kern.ssim_planes(x, y)
    ref = kern.ssim_planes_plain(x, y)
    loss = kern.ssim_loss(x, y)
    torch.cuda.synchronize()
    n, h, w, c = shape
    check(got.shape == (n, c) and got.dtype == torch.float32,
          f"{name}: output {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    check(bool(torch.equal(got, again)),
          f"{name}: two launches on the same inputs differ")
    max_abs = float((got - ref).abs().max())
    loss_err = abs(float(loss) - float(ref.mean(dim=0).sum()))
    if same:
        check(float(got.abs().max()) == 0.0 and float(loss) == 0.0,
              f"{name}: loss of x against itself is {float(loss)!r}, not 0")
    turn = [0]

    def rotate(fn):
        def call():
            turn[0] = (turn[0] + 1) % len(pairs)
            return fn(*pairs[turn[0]])
        return call

    ms = device_ms(torch, rotate(kern.ssim_planes), reps=200)
    plain_ms = device_ms(torch, rotate(kern.ssim_planes_plain), reps=40)
    nbytes = 2 * x.numel() * x.element_size() + 4 * n * c
    # per output value: 15 for the horizontal sums, 10 for the vertical
    # ones, about 30 for the SSIM map and the clip, 1 to accumulate
    flops = 56 * n * (h - 2) * (w - 2) * c
    b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOP_PER_S)
    rec = dict(case=name, kernel="ssim_loss", shape=list(shape),
               dtype=dtype_name, max_abs_err=max_abs, loss_abs_err=loss_err,
               plane_err_bound=SSIM_PLANE_TOL, loss=float(loss), ms=ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    check(max_abs <= SSIM_PLANE_TOL,
          f"{name}: plane error {max_abs:.3e} > {SSIM_PLANE_TOL:.0e}")
    return rec


# ---- phase 3: the serving slice --------------------------------------------

def random_flat_params(seed: int, n_channels: int = 8):
    """A flat flax-style weight map ("params/col_1/down_01/Conv_0/kernel")
    for the full-width GridNet, made with numpy from ``seed``:
    lecun-scaled kernels, small biases, PReLU slopes 0.25."""
    from video_layout_generation_tpu_torch.models import GridNet
    return _random_flat(GridNet(n_channels=n_channels,
                                filters_level=FILTERS), seed, gain=1.0)


def random_flat_relu_net(module, seed: int):
    """The same for a conv -> ReLU net (VGG19, HNED): He-scaled 3x3 kernels
    keep the activations' size through the trunk. HNED's 1x1 score kernels
    are scaled down by 50, so that the scores of its [0, 255]-ranged input
    are O(1) and the sigmoid edge maps do not saturate."""
    flat = _random_flat(module, seed, gain=2.0)
    for key in flat:
        if "/score" in key and key.endswith("kernel"):
            flat[key] = flat[key] * np.float32(0.02 / np.sqrt(2.0))
    return flat


def _random_flat(module, seed: int, gain: float):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, t in sorted(module.state_dict().items()):
        shape = tuple(t.shape)
        if key.endswith("kernel"):
            v = rng.standard_normal(shape) * np.sqrt(
                gain / np.prod(shape[:3]))
        elif key.endswith("bias"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = np.full(shape, 0.25)
        flat["params/" + key.replace(".", "/")] = v.astype(np.float32)
    return flat


def make_request(n: int, seed: int):
    """Blocky random frames and layouts (8x8-pixel cells) at 256x256."""
    rng = np.random.default_rng(seed)
    cells = (n, HW[0] // 8, HW[1] // 8)

    def up(a):
        return a.repeat(8, axis=1).repeat(8, axis=2)

    img1 = up(rng.random(cells + (3,))).astype(np.float32)
    img2 = np.clip(img1 + 0.05 * up(rng.standard_normal(cells + (3,))),
                   0, 1).astype(np.float32)
    seg1 = up(rng.integers(0, 20, cells))
    seg2 = seg1.copy()
    return img1, img2, seg1, seg2


def check_output(name, frames, layouts, n):
    check(frames.shape == (n, FRAMES) + HW + (3,),
          f"{name}: frames {frames.shape}")
    check(layouts.shape == (n, FRAMES) + HW, f"{name}: layouts "
          f"{layouts.shape}")
    check(bool(np.isfinite(frames).all()), f"{name}: non-finite frames")
    check(frames.min() >= 0.0 and frames.max() <= 1.0,
          f"{name}: frames outside [0, 1]")
    check(layouts.min() >= 0 and layouts.max() < 20,
          f"{name}: layout ids outside [0, 20)")


def counted_call(torch, kern, name, fn, expected):
    """Run ``fn`` and check the launches it made against ``expected``."""
    before = kern.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kern.launch_counts()
    diff = {k: after[k] - before[k] for k in after}
    check(diff == expected, f"{name}: launches {diff}, expected {expected}")
    return out, diff


def run_slice(torch, kern, seed: int):
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    flat = random_flat_params(seed)
    kw = dict(n_frames=FRAMES, batch=BATCH, image_hw=HW,
              filters_level=FILTERS, use_bf16=True, device=DEVICE)
    pred = LayoutPredictor("GridNet", flat, **kw)
    req = make_request(BATCH, seed + 1)
    small = tuple(a[:5] for a in req)

    kern.reset_launch_counts()
    per_request = []

    def counted(name, fn):
        out, diff = counted_call(torch, kern, name, fn, LAUNCHES_PER_ROLLOUT)
        per_request.append((name, diff))
        return out

    t0 = time.perf_counter()
    full = counted("full", lambda: pred.predict(*req))
    padded = counted("padded n=5", lambda: pred.predict(*small))
    piped = counted("pipelined",
                    lambda: list(pred.predict_pipelined([req]))[0])
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"slice: 3 requests in {main_s:.3f} s; launches per request "
          f"{per_request}; total {launches}", flush=True)

    check_output("full", *full, BATCH)
    check_output("padded", *padded, 5)
    check_output("pipelined", *piped, BATCH)
    check(np.array_equal(padded[0], full[0][:5])
          and np.array_equal(padded[1], full[1][:5]),
          "padded request differs from the full request's first 5")
    check(np.array_equal(piped[0], full[0])
          and np.array_equal(piped[1], full[1]),
          "pipelined request differs from predict")

    ref = LayoutPredictor("GridNet", flat, plain=True, **kw).predict(*req)
    agree, img_err = [], []
    for t in range(FRAMES):
        agree.append(float((full[1][:, t] == ref[1][:, t]).mean()))
        img_err.append(float(np.abs(full[0][:, t] - ref[0][:, t]).max()
                             / max(np.abs(ref[0][:, t]).max(), 1e-30)))
    print("slice vs plain: layout agreement per frame "
          + json.dumps(agree) + "; image normalized error per frame "
          + json.dumps(img_err), flush=True)
    check(img_err[0] <= IMG_MAX_TOL,
          f"step 1 image error {img_err[0]:.3e} > {IMG_MAX_TOL:.0e}")
    check(agree[0] >= 0.99, f"step 1 layout agreement {agree[0]:.4f} < 0.99")

    # rollout throughput at b16 and latency at b1 (host clock, upload to
    # fetch; every predict ends in a device->host copy)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(*req)
        times.append(time.perf_counter() - t0)
    fps = BATCH * FRAMES / min(times)
    pred1 = LayoutPredictor("GridNet", flat, **dict(kw, batch=1))
    one = tuple(a[:1] for a in req)
    pred1.predict(*one)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred1.predict(*one)
        lat.append(time.perf_counter() - t0)
    print(f"slice timing: b{BATCH} predict times s {json.dumps(times)}; "
          f"rollout frames/s {fps:.1f}; b1 latency s median "
          f"{sorted(lat)[2]:.4f} all {json.dumps(lat)}", flush=True)
    profile_call("no-edge b16 request", lambda: pred.predict(*req))
    return launches, dict(fps=fps, b1_latency_s=sorted(lat)[2],
                          agreement=agree, img_err=img_err)


def profile_call(name, fn):
    """Device time by kernel over one call of ``fn`` (which must end in a
    fetch or a synchronize), and the device's busy time beside the call's
    wall time. Op-level (aten::) and runtime-API rows are left out so that
    no device time is counted twice."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0 and not ev.key.startswith(("aten::", "cuda",
                                                 "Activity")):
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"profile [{name}]: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_s * 1e3:.1f} ms, idle share {1 - busy_s / wall:.3f}",
          flush=True)
    # the 15 largest rows, and the SSIM kernels wherever they rank
    for dev_us, count, key in rows[:15] + [r for r in rows[15:]
                                           if "ssim_" in r[2]]:
        print(f"profile: {dev_us / 1e3:9.2f} ms {count:6d}x {key[:90]}",
              flush=True)


# ---- phases 4 and 5: the edge-mode validation step and rollout ---------------

def edge_mode_weights(seed: int):
    """Flat flax-style weights of the three nets of the edge-mode path: the
    10-channel GridNet, HNED and VGG19 to relu4_4."""
    from video_layout_generation_tpu_torch.losses import VGG19Features
    from video_layout_generation_tpu_torch.models import HNED
    return dict(gridnet=random_flat_params(seed + 10, n_channels=10),
                hned=random_flat_relu_net(HNED(), seed + 11),
                vgg=random_flat_relu_net(VGG19Features(), seed + 12))


def make_packed_batch(n: int, seed: int):
    """One uint8 ``packed6`` batch (n, H, W, 12): three blocky frames that
    drift a little and three layouts."""
    img1, img2, seg1, seg2 = make_request(n, seed)
    rng = np.random.default_rng(seed + 1000)
    cells = (n, HW[0] // 8, HW[1] // 8)
    drift = rng.standard_normal(cells + (3,)).repeat(8, axis=1).repeat(
        8, axis=2)
    img3 = np.clip(img2 + 0.05 * drift, 0, 1)
    seg3 = np.where(rng.random(seg2.shape) < 0.9, seg2,
                    rng.integers(0, N_CLASSES, seg2.shape))
    frames = [(f * 255.0 + 0.5).astype(np.uint8) for f in (img1, img2, img3)]
    segs = [s.astype(np.uint8)[..., None] for s in (seg1, seg2, seg3)]
    return {"packed6": np.concatenate(frames + segs, axis=-1)}


def run_validation(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    from video_layout_generation_tpu_torch.models import HNED, GridNet
    from video_layout_generation_tpu_torch.train.assemble import \
        normalize_model_output
    from video_layout_generation_tpu_torch.train.steps import (
        decode_batch, make_eval_step, prepare_inputs)
    from video_layout_generation_tpu_torch.train.trainer import validate
    dt = torch.bfloat16
    model = GridNet(n_channels=10, filters_level=FILTERS, dtype=dt)
    model.load_state_dict(params_from_flax(weights["gridnet"]), strict=True)
    hned = HNED(dtype=dt)
    hned.load_state_dict(params_from_flax(weights["hned"]), strict=True)
    # the nets are built on the CPU; make_eval_step moves them to the card,
    # and CombinedLoss.create picks bf16 there
    combined = CombinedLoss.create(params=weights["vgg"],
                                   device=DEVICE).eval_variant()
    step = make_eval_step(model, hned, combined, n_classes=N_CLASSES,
                          device=DEVICE)
    plain_step = make_eval_step(model, hned, combined, n_classes=N_CLASSES,
                                plain=True, device=DEVICE)
    check(all(p.device.type == "cuda" for net in
              (model, hned, combined.vgg_model) for p in net.parameters()),
          "make_eval_step left a net off the card")
    batches = [make_packed_batch(BATCH, seed + 20 + i)
               for i in range(VAL_BATCHES)]
    first = {"cm_total": 0.0}

    def counted_step(batch):
        out, _ = counted_call(torch, kern, "eval step", lambda: step(batch),
                              LAUNCHES_PER_EVAL_STEP)
        first.setdefault("out", out)
        first["cm_total"] += float(out[0]["cm"].sum())
        return out

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    result = validate(counted_step, batches, N_CLASSES)
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"validation: {VAL_BATCHES} batches of {BATCH} in {main_s:.3f} s; "
          f"launches per eval step {LAUNCHES_PER_EVAL_STEP}; total "
          f"{launches}", flush=True)

    n_px = VAL_BATCHES * BATCH * HW[0] * HW[1]
    check(np.isfinite(result["loss"]), f"validation loss {result['loss']}")
    check(0.0 <= result["miou"] <= 1.0 and 0.0 <= result["pixel_acc"] <= 1.0,
          f"validation scores {result['miou']}, {result['pixel_acc']}")
    check(result["per_class_iou"].shape == (N_CLASSES,), "per-class IoU shape")
    metrics, seg_ids, img_n = first["out"]
    check(tuple(seg_ids.shape) == (BATCH,) + HW
          and tuple(img_n.shape) == (BATCH,) + HW + (3,),
          f"eval step outputs {tuple(seg_ids.shape)} {tuple(img_n.shape)}")
    check(bool(torch.isfinite(img_n).all()), "eval step: non-finite frame")
    check(first["cm_total"] == n_px,
          f"confusion total {first['cm_total']} != {n_px}")

    ref_metrics, ref_ids, ref_img = plain_step(batches[0])
    terms = {}
    for k in ("loss", "loss_l1", "loss_style", "loss_seg"):
        a, b = float(metrics[k]), float(ref_metrics[k])
        terms[k] = dict(kernels=a, plain=b, rel_err=abs(a - b) / abs(b))
    agree = float((seg_ids == ref_ids).float().mean())
    diff = (img_n - ref_img).abs()
    top = ref_img.abs().max()
    img_err = float(diff.max() / top)
    img_share = float((diff <= IMG_MAX_TOL * top).float().mean())
    img_mean_err = float(diff.mean() / ref_img.abs().mean())
    # the cause of the end-to-end maximum, taken apart: HNED alone, then
    # GridNet alone on one shared, plain HNED edge map
    with torch.no_grad():
        batch0 = decode_batch({"packed6": torch.from_numpy(
            batches[0]["packed6"]).to(DEVICE)})
        edge_err = float((hned(batch0["img1"])[-1]
                          - hned(batch0["img1"], plain=True)[-1]).abs().max())
        x, _ = prepare_inputs(hned, batch0, plain=True)
        seg_k, out_k = model(x)
        seg_p, out_p = model(x, plain=True)
        out_k = normalize_model_output(out_k.float())
        out_p = normalize_model_output(out_p.float())
    shared_img_err = float((out_k - out_p).abs().max() / out_p.abs().max())
    shared_agree = float((seg_k.argmax(-1) == seg_p.argmax(-1)).float().mean())
    print("validation vs plain: " + json.dumps(terms) + f"; layout agreement "
          f"{agree:.5f}; image normalized error max {img_err:.4f} mean "
          f"{img_mean_err:.5f}, share within {IMG_MAX_TOL:.0e} "
          f"{img_share:.6f}; HNED edge map max abs error {edge_err:.4f}; "
          f"GridNet on one shared plain edge map: image normalized error max "
          f"{shared_img_err:.4f}, layout agreement {shared_agree:.5f}",
          flush=True)
    check(edge_err <= EDGE_MAP_TOL,
          f"HNED edge map error {edge_err:.3e} > {EDGE_MAP_TOL:.0e}")
    check(shared_img_err <= IMG_MAX_TOL,
          f"GridNet on shared edges: image error {shared_img_err:.3e} > "
          f"{IMG_MAX_TOL:.0e}")
    check(shared_agree >= 0.99,
          f"GridNet on shared edges: layout agreement {shared_agree:.4f}")
    check(img_share >= EDGE_IMG_SHARE,
          f"eval image: only {img_share:.6f} of the values within "
          f"{IMG_MAX_TOL:.0e} of the maximum")
    for k, v in terms.items():
        check(v["rel_err"] <= LOSS_TERM_RTOL,
              f"{k}: {v['kernels']} vs plain {v['plain']}, relative error "
              f"{v['rel_err']:.3e} > {LOSS_TERM_RTOL:.0e}")
    check(agree >= 0.99, f"eval layout agreement {agree:.4f} < 0.99")
    check(img_mean_err <= EDGE_IMG_MEAN_TOL,
          f"eval mean image error {img_mean_err:.3e} > "
          f"{EDGE_IMG_MEAN_TOL:.0e}")

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = validate(step, batches, N_CLASSES)   # ends in a fetch
        times.append(time.perf_counter() - t0)
    check(again["loss"] == result["loss"],
          f"validation is not repeatable: {again['loss']} {result['loss']}")
    sps = VAL_BATCHES * BATCH / min(times)
    print(f"validation timing: {VAL_BATCHES} x b{BATCH} times s "
          f"{json.dumps(times)}; validation samples/s {sps:.1f}; loss "
          f"{result['loss']:.4f} mIoU {result['miou']:.4f} pixAcc "
          f"{result['pixel_acc']:.4f}", flush=True)

    def one_step():
        float(step(batches[0])[0]["loss"])

    profile_call("eval step b16", one_step)
    return launches, dict(samples_per_s=sps, terms=terms, agreement=agree,
                          loss=result["loss"])


def run_edge_rollout(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.models import HNED
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    kw = dict(n_frames=FRAMES, batch=BATCH, image_hw=HW,
              filters_level=FILTERS, use_bf16=True, device=DEVICE,
              use_edges=True, hned_params=weights["hned"])

    def predictor(**over):
        return LayoutPredictor("GridNet", weights["gridnet"],
                               hned=HNED(dtype=torch.bfloat16),
                               **dict(kw, **over))

    pred = predictor()
    req = make_request(BATCH, seed + 31)
    small = tuple(a[:5] for a in req)

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    full, _ = counted_call(torch, kern, "edge full",
                           lambda: pred.predict(*req),
                           LAUNCHES_PER_EDGE_ROLLOUT)
    padded, _ = counted_call(torch, kern, "edge padded n=5",
                             lambda: pred.predict(*small),
                             LAUNCHES_PER_EDGE_ROLLOUT)
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"edge rollout: 2 requests in {main_s:.3f} s; launches per request "
          f"{LAUNCHES_PER_EDGE_ROLLOUT}; total {launches}", flush=True)
    check_output("edge full", *full, BATCH)
    check_output("edge padded", *padded, 5)
    check(np.array_equal(padded[0], full[0][:5])
          and np.array_equal(padded[1], full[1][:5]),
          "padded edge request differs from the full request's first 5")

    ref = predictor(plain=True).predict(*req)
    agree, img_err, img_mean_err, img_share = [], [], [], []
    for t in range(FRAMES):
        agree.append(float((full[1][:, t] == ref[1][:, t]).mean()))
        diff = np.abs(full[0][:, t] - ref[0][:, t])
        top = max(np.abs(ref[0][:, t]).max(), 1e-30)
        img_err.append(float(diff.max() / top))
        img_share.append(float((diff <= IMG_MAX_TOL * top).mean()))
        img_mean_err.append(float(diff.mean()
                                  / max(np.abs(ref[0][:, t]).mean(), 1e-30)))
    print("edge rollout vs plain: layout agreement per frame "
          + json.dumps(agree) + "; image normalized error per frame max "
          + json.dumps(img_err) + " mean " + json.dumps(img_mean_err)
          + f" share within {IMG_MAX_TOL:.0e} " + json.dumps(img_share),
          flush=True)
    check(img_share[0] >= EDGE_IMG_SHARE,
          f"edge step 1: only {img_share[0]:.6f} of the image values within "
          f"{IMG_MAX_TOL:.0e} of the maximum")
    check(img_mean_err[0] <= EDGE_IMG_MEAN_TOL,
          f"edge step 1 mean image error {img_mean_err[0]:.3e} > "
          f"{EDGE_IMG_MEAN_TOL:.0e}")
    check(agree[0] >= 0.99,
          f"edge step 1 layout agreement {agree[0]:.4f} < 0.99")

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        pred.predict(*req)
        times.append(time.perf_counter() - t0)
    fps = BATCH * FRAMES / min(times)
    pred1 = predictor(batch=1)
    one = tuple(a[:1] for a in req)
    pred1.predict(*one)
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred1.predict(*one)
        lat.append(time.perf_counter() - t0)
    print(f"edge rollout timing: b{BATCH} predict times s "
          f"{json.dumps(times)}; edge rollout frames/s {fps:.1f}; b1 latency "
          f"s median {sorted(lat)[1]:.4f} all {json.dumps(lat)}", flush=True)
    profile_call("edge b16 request", lambda: pred.predict(*req))
    return launches, dict(fps=fps, b1_latency_s=sorted(lat)[1],
                          agreement=agree, img_err=img_err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from video_layout_generation_tpu_torch.ops import kernels as kern
        from video_layout_generation_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    cases = [run_kernel_case(torch, F, kern, c, args.seed + i)
             for i, c in enumerate(kernel_cases())]
    cases += [run_ssim_case(torch, kern, c, args.seed + 100 + i)
              for i, c in enumerate(ssim_cases())]
    # each path: counts set to 0 just before it, read just after it
    by_path = {}
    by_path["no-edge rollout"], slice_stats = run_slice(torch, kern,
                                                        args.seed)
    weights = edge_mode_weights(args.seed)
    by_path["validation"], val_stats = run_validation(torch, kern, weights,
                                                      args.seed)
    by_path["edge rollout"], edge_stats = run_edge_rollout(
        torch, kern, weights, args.seed)
    expected = {"no-edge rollout": LAUNCHES_PER_ROLLOUT,
                "validation": LAUNCHES_PER_EVAL_STEP,
                "edge rollout": LAUNCHES_PER_EDGE_ROLLOUT}
    for path, counts in by_path.items():
        for name, per_call in expected[path].items():
            check(per_call == 0 or counts[name] > 0,
                  f"{name} was not launched on the {path} path")

    by_case = {c["case"]: c for c in cases}
    entries = []
    for name, route in ROUTES.items():
        main = by_case[route["main_case"]]
        launches = {path: counts[name] for path, counts in by_path.items()}
        entries.append(dict(
            name=name, route="cuda", source=route["source"],
            replaces=route["replaces"], launches=sum(launches.values()),
            launches_by_path=launches,
            max_abs_err=max(c["max_abs_err"] for c in cases
                            if c["kernel"] == name),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["case"],
            timed_by="torch.profiler device time"))
    print(f"card: {card}; rollout frames/s at b{BATCH}: "
          f"{slice_stats['fps']:.1f}; b1 latency "
          f"{slice_stats['b1_latency_s'] * 1e3:.1f} ms; validation samples/s "
          f"at b{BATCH}: {val_stats['samples_per_s']:.1f}; edge rollout "
          f"frames/s at b{BATCH}: {edge_stats['fps']:.1f}; edge b1 latency "
          f"{edge_stats['b1_latency_s'] * 1e3:.1f} ms", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
