#!/usr/bin/env python3
"""Build kernels A and B alone and run chip_smoke.py's kernel cases for them.

A short loop for work on ``csrc/conv3x3.cu``, ``csrc/lateral.cu`` and
``csrc/conv_common.cuh``: it compiles the two sources with nvcc (sm_90a),
prints what ptxas says of registers and spills and how many tensor-core
instructions the libraries hold, then holds every A and B case of
``chip_smoke.kernel_cases()`` against its plain version (twice,
bit-identical) and times it beside cuDNN and its bound. Run from the root of
a checkout on a machine with one NVIDIA GPU and the CUDA toolkit:

    python3 tools/check_conv_kernels.py [--only SUBSTRING] [--dgrad]
                                        [--stages 2 3] [--out FILE.jsonl]

``--stages`` repeats the cases with the ring capped at each given depth
(``conv3x3.MAX_STAGES``), to compare them within one run on one card. With
``--out`` every case's record is also written to that file, one JSON object a
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="", help="run cases whose name holds this")
    ap.add_argument("--dgrad", action="store_true",
                    help="also the data-gradient cases of kernel A")
    ap.add_argument("--stages", type=int, nargs="*", default=[],
                    help="ring depths to compare (default: the plan's)")
    ap.add_argument("--out", default="",
                    help="also write the cases' records to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("check_conv_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video_layout_generation_tpu_torch.ops import kernels as kern
    from video_layout_generation_tpu_torch.ops.kernels import (_build, conv3x3,
                                                               lateral)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(cs.TENSOR_CORE_KERNELS)
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    cs.check_no_spills(logs)
    cs.count_tensor_core_instructions(_build)

    cases = [c for c in cs.kernel_cases() if args.only in c[1]]
    failed = []
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out or os.devnull, "w")
    for depth in args.stages or [conv3x3.MAX_STAGES]:
        conv3x3.MAX_STAGES = depth
        conv3x3.conv_plan.cache_clear()
        lateral.lateral_plan.cache_clear()
        print(f"ring capped at {depth} stages", flush=True)
        for i, case in enumerate(cases):
            try:
                recs = [cs.run_kernel_case(torch, F, kern, case,
                                           args.seed + i)]
                if args.dgrad and case[7]:
                    recs.append(cs.run_dgrad_case(torch, kern, case,
                                                  args.seed + 300 + i))
                for rec in recs:
                    out.write(json.dumps(dict(rec, max_stages=depth)) + "\n")
                    out.flush()
            except cs.SmokeFailure as e:
                failed.append(f"stages {depth}: {e}")
                print(f"FAILED {e}", flush=True)
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
