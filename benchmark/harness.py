"""Run one cell of the benchmark once and assemble its result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a model
configuration (its ``file``), a traffic mix
(``<bench>/traffic/<traffic>.json``, whose ``driver`` names the general
generator ``<bench>/drivers/<driver>.py`` that reads it) and the limits
of its output check (``<bench>/limits/<cell>.json``). A per-layer metric
is read by ``<bench>/metrics/<metric>.py``. Each is found by name, so a
later cell, traffic mix or metric is a new file and a new entry, and no
edit.

A driver module defines ``Driver(cell, seed, device)`` with:

- ``setup()``: build the system under test from the seed and warm up every
  shape the cell uses;
- ``window(seconds)``: drive the traffic for ``seconds``; returns
  ``{"metrics": {name: value}, "attempted": n, "failed": n}``;
- ``profile(counters)``: a profiled slice (``trace.Trace``), taken again
  until the trace holds as many kernels of each name pattern as the
  program's launch counter of that name moved (``counters``: counter ->
  patterns, from the readers' ``COUNTERS``);
- ``layer_context(trace)``: what the per-layer readers read;
- ``release()``: free the program's state;
- ``check()``: ``{name: value}`` of the numbers compared with the
  reference, each held against ``cell.limits[name]``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "video_layout_generation_tpu")


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole: the port's name begins with the JAX
    package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path
    workload: dict = field(default_factory=dict)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    wl = _by_name(spec["workloads"], name, "workload")
    cfg = _by_name(spec["configs"], wl["config"], "config")
    bench = root / spec["paths"][0]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, chips=wl["chips"], config=_json(root / cfg["file"]),
                traffic=_json(bench / "traffic" / f"{wl['traffic']}.json"),
                limits=_json(bench / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, bench=bench, workload=wl)


def load_module(path: Path, alias: str):
    spec = importlib.util.spec_from_file_location(alias, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def driver_module(cell: Cell):
    kind = cell.traffic["driver"]
    return load_module(cell.bench / "drivers" / f"{kind}.py",
                       f"bench_driver_{kind}")


def reader(cell: Cell, metric: str):
    return load_module(cell.bench / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


def card(device) -> dict:
    """Name and power limit of the card, or the CPU."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        limit = out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "power_limit": limit}


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release_memory(device) -> None:
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", log=print) -> dict:
    """The result of one run of cell ``name`` (everything but the JAX
    check, which the caller makes once the window has closed)."""
    import torch
    cell = load_cell(root, name)
    readers = {m["name"]: reader(cell, m["name"]) for m in cell.per_layer}
    info = card(device)
    log(f"card: {info['kind']}, power limit {info['power_limit']}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv = driver_module(cell).Driver(cell, seed, device)
    drv.setup()
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.1f} s")
    win = drv.window(seconds)
    log(f"window {time.time() - t0 - setup_s:.1f} s")
    metrics: Dict[str, dict] = {}
    dev_out = {"platform": info["platform"], "kind": info["kind"],
               "count": cell.chips, "power_limit": info["power_limit"]}
    breakdown = None
    if trace:
        counters = {}
        for r in readers.values():
            counters.update(getattr(r, "COUNTERS", {}))
        tr = drv.profile(counters)
        ctx = drv.layer_context(tr)
        ctx.update(device_name=info["kind"], log=log)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is None:
                log(f"per-layer {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_out.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        log(f"traced slice and its reading done at {time.time() - t0:.1f} s")
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev_out["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(device))
        if info["platform"] == "gpu" else 0)
    drv.release()
    release_memory(device)
    t_check = time.time()
    numbers = drv.check()
    log(f"output check {time.time() - t_check:.1f} s")
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": dev_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def check_lines(result: dict) -> List[str]:
    return [f"check {k}: {c['value']!r} limit {c['limit']!r}"
            for k, c in result["checks"].items()]


def main(argv, t0: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = load_cell(ROOT, args.workload).chips
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"this cell needs {chips} CUDA card(s); the process sees "
              f"{have}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), t0, "cuda", log)
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
