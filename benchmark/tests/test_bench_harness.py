"""The harness finds every piece by name; a cell and a metric are added by
files alone; the interval arithmetic of the trace; the JAX check; a run
without a card prints no result; BENCHMARK.json keeps to its contract."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_finds_config_cell_and_metric_by_name():
    cell = harness.load_cell(ROOT, "coordgridnet_train_b32")
    assert cell.config["arch"] == "CoordGridNet"
    assert cell.traffic["driver"] == "train" and cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "loader_wait_ms.train", "mfu.train", "conv_roofline.train",
        "device_idle.train"}
    assert set(cell.limits) == {"worst_grad_gap", "worst_tensor_grad_gap",
                                "median_change_gap"}
    assert harness.reader(cell, "mfu.train").read({"kind": "rollout"}) is None
    assert hasattr(harness.driver_module(cell), "Driver")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(name):
    cell = harness.load_cell(ROOT, name)
    assert cell.end_to_end[-1]["name"] == "setup_s"
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(cell, m["name"]).read)
        moved = {e["name"] for e in cell.end_to_end}
        assert m["moves"] in moved


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert trace.union_length(iv) == 4.0
    assert trace.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert trace.gaps(iv, -1.0, 4.0) == [(-1.0, 0.0), (3.0, 4.0)]
    assert trace.union_length([]) == 0.0


def test_trace_reads_busy_time_and_labels_gaps():
    tr = trace.Trace(wall_s=1e-5, window=(0.0, 10.0), device=[
        ("conv3x3_mma_kernel", 1.0, 3.0), ("Memcpy HtoD", 2.0, 4.0),
        ("fused_lateral_mma_kernel", 6.0, 7.0)],
        host=[("bench.loader", 4.0, 6.0), ("aten::cat", 7.0, 9.5),
              ("bench.step", 6.5, 9.9), ("bench.slice", 0.0, 10.0)])
    assert tr.busy_s == pytest.approx(4e-6)
    assert tr.window_s == pytest.approx(1e-5)
    assert tr.count(("conv3x3_mma_kernel",)) == 1
    assert tr.device_s(("mma_kernel",)) == pytest.approx(3e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["conv3x3_mma_kernel", pytest.approx(2e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["bench.loader"] == pytest.approx(2e-6)
    assert idle["aten::cat"] == pytest.approx(3e-6)
    assert idle["host idle"] == pytest.approx(1e-6)


def test_read_events_takes_the_slice_and_its_thread():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice",
         "ts": 10, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.slice",
         "ts": 12, "dur": 90, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 5,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 15, "dur": 5,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "other", "ts": 15, "dur": 5,
         "tid": 2}]
    tr = trace.read_events(events, 1e-4)
    assert tr.window == (10, 110)
    assert tr.device == [("k", 20.0, 25.0)]
    assert [h[0] for h in tr.host] == ["bench.slice", "aten::mm"]


def test_forbidden_modules_compares_top_level_names_whole():
    ok = ["video_layout_generation_tpu_torch.models", "numpy", "jaxtyping",
          "flaxen.x", "torch"]
    assert harness.forbidden_modules(ok) == []
    bad = ok + ["video_layout_generation_tpu.ops.pallas", "jax.numpy",
                "optax", "orbax.checkpoint", "flax", "jaxlib.xla"]
    assert harness.forbidden_modules(bad) == [
        "flax", "jax", "jaxlib", "optax", "orbax",
        "video_layout_generation_tpu"]


def test_a_run_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gridnet_rollout_b1", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = 24    # the check's cost with the full 24 cells fits
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == names
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    all_names = ([m["name"] for m in metrics]
                 + [w["name"] for w in SPEC["workloads"]] + list(names))
    assert len(all_names) == len(set(all_names))
    assert all(NAME.match(x) for x in all_names)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            cell = harness.load_cell(ROOT, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"trainer", "train step", "kernels", "device",
                           "serving"}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_and_a_metric_added_by_files_alone(tiny):
    """A new traffic mix, its cell and a new per-layer metric: data files,
    a reader and entries; no file of the harness is edited."""
    bench = tiny / "benchmark"
    t = json.loads((bench / "traffic" / "rollout_b1.json").read_text())
    t.update(batch=3, drain=False, rate_per_s=1000.0)
    (bench / "traffic" / "rollout_b3.json").write_text(json.dumps(t))
    (bench / "limits" / "gridnet_rollout_b3.json").write_text(
        (bench / "limits" / "gridnet_rollout_b1.json").read_text())
    (bench / "metrics" / "requests_traced.rollout.py").write_text(
        '"""Requests in the traced slice."""\n\n\n'
        'def read(ctx):\n'
        '    return ctx["trace"].count(("bench.request",)) or '
        'len(ctx["window"]["service_s"])\n')
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "gridnet_rollout_b3",
                              "config": "gridnet_edge",
                              "traffic": "rollout_b3", "chips": 1,
                              "why": "three sequences a request"})
    for m in spec["end_to_end"]:
        if m["name"] == "rollout_frames_per_s":
            m["workloads"].append("gridnet_rollout_b3")
    spec["per_layer"].append({
        "name": "requests_traced.rollout", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "serving",
        "moves": "rollout_frames_per_s", "workloads": ["gridnet_rollout_b3"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    e2e = harness.run_cell(tiny, "gridnet_rollout_b3", 2 ** 31 + 3, 0.3,
                           False, time.time(), "cpu", log=lambda m: None)
    assert e2e["correct"] is True
    assert set(e2e["metrics"]) == {"rollout_frames_per_s", "setup_s"}
    assert e2e["metrics"]["rollout_frames_per_s"]["value"] > 0
    per = harness.run_cell(tiny, "gridnet_rollout_b3", 2 ** 31 + 3, 0.3,
                           True, time.time(), "cpu", log=lambda m: None)
    assert per["metrics"]["requests_traced.rollout"]["value"] >= 1
    assert list(per)[-1] == "checks"
    assert per["device"]["window_s"] > 0
