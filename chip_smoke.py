#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (video_layout_generation_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0]

Phases:
  1. print the card's name and power limit, build the CUDA kernels from
     ``video_layout_generation_tpu_torch/csrc`` with nvcc (sm_90a);
  2. kernels: hold kernel A (prelu_conv3x3) and kernel B (fused_lateral)
     against their plain PyTorch versions in bf16 at the rollout's shapes
     (batch 16, 256x256), and time each beside its plain version, a cuDNN
     yardstick and its bound;
  3. slice: LayoutPredictor at full width (8-channel GridNet, filters
     32/64/96, 256x256, 8 frames, batch 16, bf16, random weights from
     ``--seed`` passed through the flax weight bridge) answers 3 requests
     (full, padded, pipelined); the launch counts prove every conv went
     through the kernels; step 1 is held against the same predictor on the
     plain versions; rollout frames/s, batch-1 latency and a
     torch.profiler breakdown of one b16 request are printed.

Any failure exits non-zero. The line before the last is the ``kernels``
JSON object; the last line is ``{"ok": true, "device": {...}}``. With no CUDA
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
BATCH, HW, FRAMES, FILTERS = 16, (256, 256), 8, (32, 64, 96)
DEVICE = "cuda"
LAUNCHES_PER_ROLLOUT = {"prelu_conv3x3": 31 * FRAMES,
                        "fused_lateral": 15 * FRAMES}
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


def time_ms(torch, fn, target_ms=150.0):
    """Mean device time of ``fn`` over a CUDA-event-timed run of launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(max(3, min(50, target_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---- phase 2: kernels ------------------------------------------------------

def kernel_cases():
    """(name, kernel, shape (N, H, W, Ci), Co, stride, prelu, residual,
    norm-error bound)."""
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
    b = []
    for row, shp, c in (("row0", r0, 32), ("row1", r1, 64), ("row2", r2, 96)):
        b.append((f"B {row}", shp + (c,), c, 1, True, False))
        b.append((f"B {row} +res", shp + (c,), c, 1, True, True))
    return ([("prelu_conv3x3",) + x + (1e-2,) for x in a]
            + [("fused_lateral",) + x + (2e-2,) for x in b])


def run_kernel_case(torch, F, kern, case, seed):
    kernel, name, shape, co, stride, act, with_res, tol = case
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
        args = (x, wt, bias, al, res, stride)
        fn, plain = kern.prelu_conv3x3, kern.prelu_conv3x3_plain
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_cl = x.permute(0, 3, 1, 2)   # channels_last view, no copy

        def library():
            return F.conv2d(x_cl, w_oihw, bias.to(x.dtype), stride=stride,
                            padding=1)
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
    ms = time_ms(torch, lambda: fn(*args))
    plain_ms = time_ms(torch, lambda: plain(*args))
    library_ms = time_ms(torch, library)
    b_ms, b_by = bound(nbytes, flops)
    rec = dict(case=name, kernel=kernel, shape=list(shape), co=co,
               stride=stride, max_abs_err=max_abs, norm_err=norm,
               norm_err_bound=tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    check(norm <= tol, f"{name}: normalized error {norm:.3e} > {tol:.0e}")
    return rec


# ---- phase 3: the serving slice --------------------------------------------

def random_flat_params(seed: int):
    """A flat flax-style weight map ("params/col_1/down_01/Conv_0/kernel")
    for the 8-channel full-width GridNet, made with numpy from ``seed``:
    lecun-scaled kernels, small biases, PReLU slopes 0.25."""
    from video_layout_generation_tpu_torch.models import GridNet
    shapes = {k: tuple(v.shape) for k, v in
              GridNet(n_channels=8, filters_level=FILTERS).state_dict().items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in sorted(shapes.items()):
        if key.endswith("kernel"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
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
        before = kern.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = kern.launch_counts()
        diff = {k: after[k] - before[k] for k in after}
        per_request.append((name, diff))
        check(diff == LAUNCHES_PER_ROLLOUT,
              f"{name}: launches {diff}, expected {LAUNCHES_PER_ROLLOUT}")
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
    check(img_err[0] <= 2e-2, f"step 1 image error {img_err[0]:.3e} > 2e-2")
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
    profile_request(pred, req)
    return launches, dict(fps=fps, b1_latency_s=sorted(lat)[2],
                          agreement=agree, img_err=img_err)


def profile_request(pred, req):
    """Device time by kernel over one b16 request, and the device's busy
    time beside the request's wall time. Op-level (aten::) and runtime-API
    rows are left out so that no device time is counted twice."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(*req)
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0 and not ev.key.startswith(("aten::", "cuda",
                                                 "Activity")):
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"profile: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_s * 1e3:.1f} ms, idle share {1 - busy_s / wall:.3f}",
          flush=True)
    for dev_us, count, key in rows[:15]:
        print(f"profile: {dev_us / 1e3:9.2f} ms {count:6d}x {key[:90]}",
              flush=True)


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
    launches, slice_stats = run_slice(torch, kern, args.seed)

    by_case = {c["case"]: c for c in cases}
    entries = []
    for name, route in ROUTES.items():
        main = by_case[route["main_case"]]
        check(launches[name] > 0, f"{name} was not launched on the main path")
        entries.append(dict(
            name=name, route="cuda", source=route["source"],
            replaces=route["replaces"], launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases
                            if c["kernel"] == name),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["case"]))
    print(f"card: {card}; rollout frames/s at b{BATCH}: "
          f"{slice_stats['fps']:.1f}; b1 latency "
          f"{slice_stats['b1_latency_s'] * 1e3:.1f} ms", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
