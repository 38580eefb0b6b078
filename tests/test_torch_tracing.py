"""The port's spans (``utils/profiling.py:annotate``) on the CPU: a null
context when no profiler records; under ``torch.profiler`` the serving,
rollout, trainer, loader and train-step spans nest as the README's
"Tracing a run" lists them, on the calling thread; and a profiler changes
no bit of a request's answer or of the parameters after train steps."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.models import HNED, GridNet
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train.trainer import Trainer
from video_layout_generation_tpu_torch.utils import annotate

STORE = Path(__file__).resolve().parents[1] / "artifacts_store"
HW = (32, 32)
FILTERS = (4, 6, 8)
N_FRAMES = 2
STEP_SPANS = ["step.inputs", "step.forward", "step.backward", "step.update"]
SERVE_SPANS = ["serve.pack", "serve.upload", "serve.rollout", "serve.fetch",
               "serve.decode"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recorded(fn, tmp_path):
    """``fn()`` under ``torch.profiler`` on the CPU: its result and the
    spans of the trace as (name, start, end, thread id), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"] + e["dur"]),
              e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(spans, outer, prefix=""):
    """The spans that lie within ``outer``, by start."""
    return [s for s in spans if s is not outer and s[0].startswith(prefix)
            and outer[1] <= s[1] and s[2] <= outer[2]]


def predictor() -> LayoutPredictor:
    torch.manual_seed(3)
    params = GridNet(n_channels=10, filters_level=FILTERS).state_dict()
    return LayoutPredictor("GridNet", params, n_frames=N_FRAMES, batch=2,
                           image_hw=HW, filters_level=FILTERS,
                           use_bf16=False, hned=HNED(), use_edges=True,
                           device="cpu")


def request(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.random((2,) + HW + (3,), np.float32),
            rng.random((2,) + HW + (3,), np.float32),
            rng.integers(0, 20, (2,) + HW), rng.integers(0, 20, (2,) + HW))


def trainer() -> Trainer:
    cfg = Config(dataset="synthetic", synthetic_train_size=8,
                 synthetic_val_size=4, image_size=HW, batch_size=4,
                 epochs=1, filters_level=FILTERS, compute_dtype="float32",
                 workers=2, print_freq=1, edge=True, path=None,
                 hed_weights=str(STORE / "hned_synth.npz"),
                 vgg_weights=str(STORE / "vgg_synth.npz"), device="cpu")
    t = Trainer(cfg)
    t.set_epoch(0)
    return t


def test_annotate_is_one_null_context_without_a_profiler():
    off = annotate("serve.request")
    assert off is annotate("train.step")
    assert isinstance(off, contextlib.nullcontext)
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = annotate("serve.request")
        assert not isinstance(on, contextlib.nullcontext)
    assert annotate("serve.request") is off


def test_predict_records_the_serving_and_rollout_spans(tmp_path):
    pred = predictor()
    req = request(5)
    _, spans = recorded(lambda: pred.predict(*req), tmp_path)
    assert len({s[3] for s in spans}) == 1      # the calling thread's
    (top,) = named(spans, "serve.request")
    serve = inside(spans, top, "serve.")
    assert [s[0] for s in serve] == SERVE_SPANS
    (roll,) = named(serve, "serve.rollout")
    frames = named(inside(spans, roll), "rollout.frame")
    assert len(frames) == N_FRAMES
    for f in frames:
        assert sorted(s[0] for s in inside(spans, f)) == [
            "rollout.edge", "rollout.step"]
    # HNED on the two seed frames, outside any frame
    edges = named(inside(spans, roll), "rollout.edge")
    assert len(edges) == N_FRAMES + 2
    assert all(s[2] <= frames[0][1] for s in edges[:2])
    assert all(s[1] >= top[1] and s[2] <= top[2] for s in spans)


def test_pipelined_requests_record_a_request_span_each(tmp_path):
    pred = predictor()
    reqs = [request(s) for s in (6, 7, 8)]
    outs, spans = recorded(
        lambda: list(pred.predict_pipelined(iter(reqs), depth=2)), tmp_path)
    assert len(outs) == 3
    tops = named(spans, "serve.request")
    assert len(tops) == 3
    for top in tops:
        assert [s[0] for s in inside(spans, top, "serve.")] == [
            "serve.pack", "serve.upload", "serve.rollout"]
    assert len(named(spans, "serve.fetch")) == 3
    assert len(named(spans, "serve.decode")) == 3
    assert len(named(spans, "rollout.frame")) == 3 * N_FRAMES


def test_trainer_epoch_records_the_loader_and_step_spans(tmp_path):
    t = trainer()
    _, spans = recorded(t.train, tmp_path)
    assert t.epoch_stats["steps"] == 2
    # the decode workers assembled both batches
    assert (t.epoch_stats["assembled_by_workers"],
            t.epoch_stats["assembled_on_consumer"]) == (2, 0)
    assert len({s[3] for s in spans}) == 1
    loads, steps = named(spans, "train.load"), named(spans, "train.step")
    assert len(steps) == 2 and len(named(spans, "train.log")) == 2
    assert len(loads) == 3          # two batches, then the loader's end
    for load in loads[:2]:
        held = [s[0] for s in inside(spans, load, "loader.")]
        # no pinned buffer or copy on the CPU
        assert held == ["loader.gather", "loader.collate"]
    for step in steps:
        assert [s[0] for s in inside(spans, step, "step.")] == STEP_SPANS
    outer = loads + steps + named(spans, "train.log")
    for s in spans:
        if s[0].startswith(("loader.", "step.")):
            assert any(o[1] <= s[1] and s[2] <= o[2] for o in outer), s


@pytest.mark.parametrize("what", ["predict", "train"])
def test_a_profiler_changes_no_bit(what, tmp_path):
    if what == "predict":
        req = request(9)
        plain = predictor().predict(*req)
        traced, _ = recorded(lambda: predictor().predict(*req), tmp_path)
        for a, b in zip(plain, traced):
            np.testing.assert_array_equal(a, b)
        return
    plain, traced = trainer(), trainer()
    plain.train()
    recorded(traced.train, tmp_path)
    for name in ("params", "mu", "nu"):
        a = (plain.state.params if name == "params"
             else plain.state.opt_state[name])
        b = (traced.state.params if name == "params"
             else traced.state.opt_state[name])
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
