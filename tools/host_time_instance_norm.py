#!/usr/bin/env python3
"""Host time of one InstanceNorm call of the port, for a checkout given by path.

The training paths are bound by the host (PERF.md §5), so what a kernel
wrapper costs the host counts as much as its device time. This script times
the host's side of one call (forward-only, forward that keeps rstd,
backward) at a shape whose kernels are shorter than their host path, so that
the wall time of many calls enqueued in a row is host time. ``--root`` names
the checkout whose package is imported (default: this one), so that another
commit unpacked beside it is measured by the same code on the same card:

    python3 tools/host_time_instance_norm.py [--root DIR] [--calls 2000]

Prints one JSON line: the root, the card, and the microseconds a call of
each kind (the median of 5 runs of ``--calls`` calls). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("host_time_instance_norm: no CUDA device", file=sys.stderr)
        return 2
    from video_layout_generation_tpu_torch.ops.kernels import \
        instance_norm as mod

    dev = torch.device("cuda")
    x = torch.randn((3, 17, 23, 20), device=dev).to(torch.bfloat16)
    dy = torch.randn_like(x)
    calls = {
        "fwd_only": lambda: mod.instance_norm(x),
        "fwd": lambda: mod.InstanceNormFunction.apply(x, mod.EPS),
    }
    with torch.no_grad():
        y, rstd = mod.InstanceNormFunction.apply(x, mod.EPS)
    calls["bwd"] = lambda: mod._InstanceNormBackward.apply(dy, y, rstd)
    us = {}
    with torch.no_grad():
        for name, fn in calls.items():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn()
                runs.append((time.perf_counter() - t0) / args.calls * 1e6)
                torch.cuda.synchronize()
            us[name] = statistics.median(runs)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "device": torch.cuda.get_device_name(0),
                      "host_us_a_call": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
