#!/usr/bin/env python3
"""Build the InstanceNorm kernels alone and run chip_smoke.py's InstanceNorm cases.

A short loop for work on ``csrc/instance_norm.cu`` and its launch plan
(``ops/kernels/instance_norm.py:instance_norm_plan``): it compiles the source
with nvcc (sm_90a), prints what ptxas says of registers, shared memory and
spills, then holds every case of ``chip_smoke.instance_norm_cases()`` against
the plain version (one launch a call, bit-identical repeats) and times it
beside ``F.instance_norm`` and its bound. With ``--sweep`` it also times other
plans (``candidate_plans``) at the InstanceNorm shapes of the pix2pix nets at
batch 16, each held against the plain version, so that the plan's constants
are chosen within one run on one card, and two yardsticks: ``copy_`` of the
same tensors and the host time of one wrapper call. Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 tools/check_instance_norm.py [--only SUBSTRING] [--sweep]
                                         [--out FILE.jsonl]

With ``--out`` every record is also written to that file, one JSON object a
line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SWEEP_SHAPES = ((16, 256, 256, 64), (16, 128, 128, 128), (16, 64, 64, 256),
                (16, 64, 64, 128), (16, 32, 32, 256), (16, 31, 31, 512))


def candidate_plans(mod, n, h, w, c, dtype, backward):
    """Plans as ``instance_norm_plan`` would write them: resident ones with
    row segments of 32 to 128 bytes and CTAs of 32 to 128 KB where a
    cluster of 16 holds the slice, and streaming ones (whole rows or 64-byte
    segments, clusters of 8 or 16) that hold 0, 24 or 48 KB a CTA."""
    import torch
    hw = h * w
    esize = 2 if dtype == torch.bfloat16 else 4
    bufs = 2 if backward else 1
    vec = 16 // esize
    whole = min(c, mod.MAX_LANES * vec)
    plans = []

    def plan(ct, k, held=None):
        rows = mod._cdiv(hw, k)
        k = mod._cdiv(hw, rows)
        held = rows if held is None else min(rows - 1, held)
        return dict(regime="resident" if held == rows else "streaming",
                    vec=vec, ct=ct, ctiles=mod._cdiv(c, ct), k=k, rows=rows,
                    held=held, smem=mod.smem_bytes(ct, held, esize, bufs))

    cts = sorted({min(whole, b // esize) for b in (32, 64, 128)})
    for ct in cts:
        for per_cta in (32 << 10, 64 << 10, 128 << 10):
            k = mod._cdiv(hw * ct * esize * bufs, per_cta)
            if k <= mod.MAX_CLUSTER:
                plans.append(plan(ct, k))
    for ct in sorted({whole, min(whole, 64 // esize)}):
        for k in (8, 16):
            for held in (0, 24 << 10, 48 << 10):
                if hw * ct * esize * bufs > k * held:
                    plans.append(plan(ct, k, held // (ct * esize * bufs)))
    return plans


@contextlib.contextmanager
def planned(mod, plan):
    """Make the wrappers run ``plan``: ``instance_norm_plan`` is replaced
    while the block runs."""
    own = mod.instance_norm_plan
    mod.instance_norm_plan = lambda *args, **kwargs: plan
    try:
        yield
    finally:
        mod.instance_norm_plan = own


def sweep(torch, cs, mod, out):
    """Time every candidate plan at the sweep shapes; the plan's own is
    marked. Returns the failures."""
    failed = []
    dev = torch.device("cuda")
    for shape in SWEEP_SHAPES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)
            xs = [(torch.randn(shape, generator=g, device=dev) * 1.5
                   + 2.0).to(dtype) for _ in range(3)]
            dys = [torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3)]
            fwd = [mod._forward_plain(x, mod.EPS) for x in xs]
            ys = [f[0] for f in fwd]
            rstds = [f[1].float() for f in fwd]
            want_dx = mod.instance_norm_bwd_plain(dys[1], ys[1], rstds[1])
            esize = xs[0].element_size()
            for backward in (False, True):
                own = mod.instance_norm_plan(n, h, w, c, dtype, backward,
                                             mod.sm_count(dev))
                nbytes = (3 if backward else 2) * xs[0].numel() * esize
                b_ms, _ = cs.bound(nbytes, 0)
                for plan in candidate_plans(mod, n, h, w, c, dtype,
                                            backward):
                    rec = dict(shape=list(shape), dtype=str(dtype),
                               backward=backward,
                               own=all(plan[k] == own[k] for k in
                                       ("ct", "k", "rows", "held")),
                               **{k: plan[k] for k in
                                  ("regime", "ct", "k", "rows", "held",
                                   "smem")})
                    turn = [0]
                    if backward:
                        want = want_dx

                        def call():
                            turn[0] = (turn[0] + 1) % 3
                            return mod._launch_bwd(dys[turn[0]], ys[turn[0]],
                                                   rstds[turn[0]])
                    else:
                        want = ys[1]

                        def call():
                            turn[0] = (turn[0] + 1) % 3
                            return mod._launch_fwd(xs[turn[0]], mod.EPS,
                                                   False)[0]
                    try:
                        with planned(mod, plan):
                            rec["active_clusters"] = mod.active_clusters(
                                xs[0], backward)
                            got = call()     # the inputs of turn 1
                            torch.cuda.synchronize()
                            ms = cs.device_ms(torch, call)
                        err = float((got.float() - want.float()).abs().max()
                                    / want.float().abs().max())
                        rec.update(norm_err=err, ms=ms, bound_ms=b_ms)
                        rec["share"] = b_ms / rec["ms"]
                        cs.check(err <= cs.IN_BF16_TOL, f"sweep {rec}: error")
                    except (RuntimeError, cs.SmokeFailure) as e:
                        rec["error"] = str(e)[:300]
                        failed.append(rec)
                    print("sweep " + json.dumps(rec), flush=True)
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    return failed


def yardsticks(torch, cs, mod, out):
    """Beside the sweep: the device time of ``copy_`` of each sweep shape
    (one read and one write: the bandwidth a plain copy reaches), and the
    host time of one wrapper call (the enqueue, at the ragged shape, whose
    kernel is shorter than its host path)."""
    dev = torch.device("cuda")
    for shape in SWEEP_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            xs = [torch.randn(shape, device=dev).to(dtype) for _ in range(3)]
            dst = torch.empty_like(xs[0])
            turn = [0]

            def call():
                turn[0] = (turn[0] + 1) % 3
                dst.copy_(xs[turn[0]])
            ms = cs.device_ms(torch, call)
            nbytes = 2 * xs[0].numel() * xs[0].element_size()
            rec = dict(yardstick="copy_", shape=list(shape), dtype=str(dtype),
                       ms=ms, bound_ms=cs.bound(nbytes, 0)[0],
                       tb_per_s=nbytes / ms / 1e9)
            print("yardstick " + json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
    x = torch.randn((3, 17, 23, 20), device=dev).to(torch.bfloat16)
    for name, fn in (("fwd_only", lambda: mod.instance_norm(x)),
                     ("fwd", lambda: mod.InstanceNormFunction.apply(
                         x, mod.EPS))):
        with torch.no_grad():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            host = (time.perf_counter() - t0) / 2000
            torch.cuda.synchronize()
        rec = dict(yardstick="host time a call", call=name,
                   us=host * 1e6)
        print("yardstick " + json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="run cases whose dtype, shape or kind holds this")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other launch plans (see above)")
    ap.add_argument("--out", default="",
                    help="also write the records to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("check_instance_norm: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video_layout_generation_tpu_torch.ops import kernels as kern
    from video_layout_generation_tpu_torch.ops.kernels import _build
    mod = kern.instance_norm

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(("instance_norm",))
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out or os.devnull, "w")
    failed = []
    for i, case in enumerate(cs.instance_norm_cases()):
        if args.only not in f"{case[1]} {case[0]} {case[2]}":
            continue
        try:
            for rec in cs.run_instance_norm_case(torch, F, kern, case,
                                                 args.seed + 200 + i):
                out.write(json.dumps(rec) + "\n")
                out.flush()
        except (RuntimeError, cs.SmokeFailure) as e:
            failed.append(str(e))
            print(f"FAILED {e}", flush=True)
    if args.sweep:
        failed += sweep(torch, cs, mod, out)
        yardsticks(torch, cs, mod, out)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
