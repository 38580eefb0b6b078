#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line on standard output is the result as one JSON object; the
last lines on standard error are the numbers of the output check, each
beside its limit. Exits with 2 where the process sees fewer CUDA cards
than the cell needs, and with 3 where a module of JAX or of the JAX
package was loaded.
"""

import time

T0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                               "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
