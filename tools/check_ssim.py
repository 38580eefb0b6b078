#!/usr/bin/env python3
"""Build the SSIM kernel alone and run chip_smoke.py's SSIM cases.

A short loop for work on ``csrc/ssim.cu`` and its launch plan
(``ops/kernels/ssim.py:ssim_plan``): it compiles the source with nvcc
(sm_90a), prints what ptxas says of registers, shared memory and spills, then
holds every case of ``chip_smoke.ssim_cases()`` against the plain version
(one launch a call, bit-identical repeats, x == y exactly 0) and times it
beside the plain version, a ``copy_`` of the same bytes and its bound. With
``--sweep`` it also times other plans at the validation step's shape
(16, 256, 256, 3) in f32 and bf16, and at batch 1: cluster sizes K (which
set the rows a CTA, ``rows = ceil(254 / K)``) and ring depths, each held
against the plain version, so that the plan's constants are chosen within
one run on one card.

``--host-time`` instead prints the host time of one ``ssim_planes`` call
(the median of 5 runs of ``--calls`` calls at (2, 16, 16, 3) f32, whose
kernel is shorter than its host path) for the checkout named by ``--root``
(default: this one), so that another commit unpacked beside it is measured by
the same code on the same card. Run from the root of a checkout on a machine
with one NVIDIA GPU and the CUDA toolkit:

    python3 tools/check_ssim.py [--only SUBSTRING] [--sweep] [--out FILE.jsonl]
    python3 tools/check_ssim.py --host-time [--root DIR] [--calls 2000]

With ``--out`` every record is also written to that file, one JSON object a
line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_SHAPES = ((16, 256, 256, 3), (1, 256, 256, 3))
SWEEP_K = (4, 5, 6, 8, 16)
SWEEP_STAGES = (None, 8)   # None: the plan's, one CTA an SM
HOST_SHAPE = (2, 16, 16, 3)


def host_time(root: str, calls: int) -> int:
    """Print the host microseconds of one ``ssim_planes`` call of the port
    found under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        print("check_ssim: no CUDA device", file=sys.stderr)
        return 2
    from video_layout_generation_tpu_torch.ops.kernels import ssim as mod
    dev = torch.device("cuda")
    x = torch.rand(HOST_SHAPE, device=dev)
    y = torch.rand(HOST_SHAPE, device=dev)
    with torch.no_grad():
        for _ in range(100):
            mod.ssim_planes(x, y)
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                mod.ssim_planes(x, y)
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    print(json.dumps({"root": os.path.abspath(root),
                      "module": mod.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "shape": list(HOST_SHAPE),
                      "host_us_a_call": statistics.median(runs),
                      "runs_us": runs}), flush=True)
    return 0


def sweep(torch, cs, mod, out):
    """Time every plan of the sweep at the sweep shapes; the plan's own is
    marked. Returns the failures."""
    failed = []
    for shape in SWEEP_SHAPES:
        n, h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            pairs = cs.ssim_inputs(torch, shape, dtype, False, 7)
            want = mod.ssim_planes_plain(*pairs[0])
            own = mod.plan_for(pairs[0][0])
            b_ms = cs.ssim_bound(torch, shape, dtype)[0]
            seen = set()
            for k, stages in itertools.product(SWEEP_K, SWEEP_STAGES):
                try:
                    plan = mod.ssim_plan(n, h, w, c, dtype, k=k,
                                         stages=stages)
                except ValueError:
                    continue     # a plan the kernel does not take
                key = tuple(sorted(plan.items()))
                if key in seen:
                    continue
                seen.add(key)
                rec = dict(shape=list(shape), dtype=str(dtype),
                           own=plan == own, **plan)
                turn = [0]

                def call():
                    turn[0] = (turn[0] + 1) % len(pairs)
                    return mod._launch(*pairs[turn[0]], plan=plan)
                try:
                    rec["active_clusters"] = mod.active_clusters(
                        pairs[0][0], plan)
                    got = mod._launch(*pairs[0], plan=plan)
                    again = mod._launch(*pairs[0], plan=plan)
                    torch.cuda.synchronize()
                    ms = cs.device_ms(torch, call, reps=100)
                    err = float((got - want).abs().max())
                    rec.update(max_abs_err=err, ms=ms, bound_ms=b_ms,
                               share=b_ms / ms)
                    cs.check(err <= cs.SSIM_PLANE_TOL,
                             f"sweep {rec}: error")
                    cs.check(bool(torch.equal(got, again)),
                             f"sweep {rec}: repeats differ")
                except (RuntimeError, cs.SmokeFailure) as e:
                    rec["error"] = str(e)[:300]
                    failed.append(rec)
                print("sweep " + json.dumps(rec), flush=True)
                out.write(json.dumps(rec) + "\n")
                out.flush()
    return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="run cases whose name holds this")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other launch plans (see above)")
    ap.add_argument("--host-time", action="store_true",
                    help="print the host time of one call and stop")
    ap.add_argument("--root", default=ROOT,
                    help="with --host-time: checkout to import the port from")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--out", default="",
                    help="also write the records to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.host_time:
        return host_time(args.root, args.calls)

    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("check_ssim: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video_layout_generation_tpu_torch.ops import kernels as kern
    from video_layout_generation_tpu_torch.ops.kernels import _build

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(("ssim",))
    print("clusters of 1..16 CTAs the card runs at once, one CTA an SM: "
          f"{kern.ssim.cluster_capacity(torch.device('cuda'))}", flush=True)
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line \
                    or "smem" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out or os.devnull, "w")
    failed = []
    for i, case in enumerate(cs.ssim_cases()):
        if args.only not in case[0]:
            continue
        try:
            rec = cs.run_ssim_case(torch, kern, case, args.seed + 100 + i)
            out.write(json.dumps(rec) + "\n")
            out.flush()
        except (RuntimeError, cs.SmokeFailure) as e:
            failed.append(str(e))
            print(f"FAILED {e}", flush=True)
    if args.sweep:
        failed += sweep(torch, cs, kern.ssim, out)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
