"""A tiny copy of the benchmark for the CPU: the committed tree with every
configuration cut to 32 x 32 and widths 4 / 6 / 8, in float32 (the port's
plain versions on the CPU), and small batches and windows.

Run from the root of a checkout:

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = dict(image_hw=[32, 32], filters_level=[4, 6, 8], scenes=16,
                   compute_dtype="float32")
TINY_TRAFFIC = {
    "train": dict(batch=4, epoch_steps=4, workers=2, check_block=2,
                  profile_steps=1),
    "rollout": dict(batch=2, n_frames=3, pool_requests=4, check_requests=2,
                    check_block=1, profile_requests=2),
}
# limits of the tiny float32 cells: the port's plain float32 path against
# the float32 reference reads up to about 1e-3 in the widest gradient gap,
# 3e-4 in the median change and 1e-5 in the rollouts
TINY_LIMITS = {"worst_grad_gap": 1e-2, "worst_tensor_grad_gap": 1e-2,
               "median_change_gap": 5e-3,
               "layout_gap": 1e-3, "frame_err": 1e-3}


# the rollout-fidelity recipe's traffic is committed without a cell
# (PERF.md, Open questions); the tiny tree gives it one, so that its path
# through the train driver stays tested
RECIPE = {"name": "gridnet_recipe_k4_b32", "config": "gridnet_edge",
          "traffic": "recipe_k4_b32", "chips": 1, "why": "K-step recipe"}


def make_tiny(dest: Path) -> Path:
    """The benchmark at ``dest``: BENCHMARK.json and a ``benchmark``
    directory with the committed drivers and readers and tiny data."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(RECIPE)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "coordgridnet_train_b32" in m.get("workloads", ()):
            m["workloads"].append(RECIPE["name"])
    bench = dest / spec["paths"][0]
    for sub in ("drivers", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY_CONFIG)
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((ROOT / "benchmark" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        t.update(TINY_TRAFFIC[t["driver"]])
        if t.get("multistep_k", 1) > 1:
            t["multistep_k"] = 3
        (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        like = "coordgridnet_train_b32" if w is RECIPE else w["name"]
        lim = json.loads((ROOT / "benchmark" / "limits"
                          / f"{like}.json").read_text())
        (bench / "limits" / f"{w['name']}.json").write_text(
            json.dumps({k: TINY_LIMITS[k] for k in lim}))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path / "tiny")
