#!/usr/bin/env python3
"""Readings of a cell's output check on many seeds: the program's, the
control's, and those of planted faults. The limits in ``limits/<cell>.json``
are set from these (PERF.md gives the readings and the limits). The
benchmark's own runs do not run this.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
        [--seconds 3] [--out chiprun_out/control.jsonl]

For each seed, in one process: the cell's set-up (for training: its first
steps, which are what the check follows; for serving: a window of
``--seconds`` at the cell's load), then

- ``program``: the numbers the check compares, as a run reads them
  (training: with ``raw``, each side's losses and per-leaf norms);
- ``control``: the same numbers with the float32 reference, rounded to
  float8 at every convolution (``reference/quant.py``), in the program's
  place;
- training: ``half_batch``: the reference on the first half of each
  step's rows, the mean taken over them, in the program's place (a step
  that returns its state unchanged reads 1 on the gradient and the change
  by their definition and needs no run);
- serving: ``altered``: the served answers with one layout id and one
  frame value changed where they are produced.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference.quant import fp8  # noqa: E402


def look(mod, prog: dict, ref: dict, sizes: dict) -> dict:
    """Where a training number comes from: each step's loss gap, the
    leaves with the widest gradient and change gaps (each with its size
    and its reference gradient over the median leaf's), the leaves left
    out of the change."""
    g, c = mod.leaf_gaps(prog, ref)
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    top = lambda d: [(k, v, sizes[k], g_ref[k] / g_med)  # noqa: E731
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:4]]
    return {"step_loss_gaps": [mod.gap(a, b, 0.0) for a, b in
                               zip(prog["losses"], ref["losses"])],
            "grad_top": top(g), "change_top": top(c),
            "dropped": sorted(set(g) - set(c))}


def train_readings(drv, mod, full: bool = True) -> dict:
    ref = drv.follow()
    sizes = drv.sizes
    out = {"program": mod.compare(drv.prog, ref, sizes),
           "program_look": look(mod, drv.prog, ref, sizes),
           "sizes": sizes, "raw": {"reference": ref, "program": drv.prog}}
    if full:
        for name, res in (("control", drv.follow(q=fp8)),
                          ("half_batch", drv.follow(rows=drv.batch // 2))):
            out[name] = mod.compare(res, ref, sizes)
            out[name + "_look"] = look(mod, res, ref, sizes)
            out["raw"][name] = res
    return out


def rollout_readings(drv, mod, full: bool = True) -> dict:
    from benchmark.reference.train import Nets
    cand = Nets(drv.w["gen"], drv.w["hned"], None, q=fp8)
    altered = []
    for req, (frames, layouts) in drv.kept:
        f, ly = frames.copy(), layouts.copy()
        h, w = ly.shape[2] // 2, ly.shape[3] // 2
        ly[0, 0, h, w] = (ly[0, 0, h, w] + 1) % drv.cell.config["n_classes"]
        f[0, 0, h, w, 0] = (f[0, 0, h, w, 0] + 0.5) % 1.0
        altered.append((req, (f, ly)))
    args = (drv.cell, drv.w, drv.pool)
    out = {"program": mod.judge(*args, drv.kept, drv.dev),
           "requests": len(drv.kept)}
    if full:
        out["control"] = mod.judge(*args, drv.kept, drv.dev, cand)
        out["altered"] = mod.judge(*args, altered, drv.dev)
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control and the faults on the first this "
                        "many seeds only (default: all)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.Path(ROOT), args.workload)
    mod = harness.driver_module(cell)
    for seed in args.seeds:
        t0 = time.time()
        drv = mod.Driver(cell, seed, args.device)
        drv.setup()
        if cell.traffic["driver"] == "rollout":
            drv.window(args.seconds)
        drv.release()
        harness.release_memory(args.device)
        full = (args.control_seeds is None
                or args.seeds.index(seed) < args.control_seeds)
        if cell.traffic["driver"] == "rollout":
            got = rollout_readings(drv, mod, full)
        else:
            got = train_readings(drv, mod, full)
        line = json.dumps(dict(cell=args.workload, seed=seed,
                               seconds=time.time() - t0, **got))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del drv
        harness.release_memory(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
