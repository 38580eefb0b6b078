"""A run with the timed path broken underneath comes out not correct, once
for each fault its cell can have; the float8 control, put in the program's
place, comes out not correct too. The tiny float32 cells of ``conftest``,
on the CPU: the harness's look for a card is skipped, the rest of a run is
driven as on the chip."""

import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
import control  # noqa: E402

SEED = 2 ** 31 + 23


def run(tiny, name):
    return harness.run_cell(tiny, name, SEED, 0.3, False, time.time(), "cpu",
                            log=lambda m: None)


@pytest.mark.parametrize("name", ["coordgridnet_train_b32",
                                  "gridnet_recipe_k4_b32"])
def test_a_step_that_returns_its_state_unchanged(tiny, name, monkeypatch):
    from video_layout_generation_tpu_torch.train import state
    monkeypatch.setattr(state.TrainState, "apply_gradients",
                        lambda self, grads: self)
    out = run(tiny, name)
    assert out["correct"] is False
    assert out["checks"]["worst_tensor_grad_gap"]["value"] > 0.5


@pytest.mark.parametrize("name", ["coordgridnet_train_b32",
                                  "gridnet_recipe_k4_b32"])
@pytest.mark.parametrize("fault", ["lr_doubled", "parameters_unwritten"])
def test_a_wrong_update_of_the_parameters(tiny, name, fault, monkeypatch):
    """Adam's moments are updated as they should be, so the first gradient
    reads right: only the change of the parameters shows the fault."""
    from video_layout_generation_tpu_torch.train import state
    real = state.Optimizer.update

    def update(self, params, grads, opt_state):
        if fault == "parameters_unwritten":
            return real(self, {k: p.clone() for k, p in params.items()},
                        grads, opt_state)
        lr = opt_state["learning_rate"]
        opt_state["learning_rate"] = 2 * lr
        try:
            return real(self, params, grads, opt_state)
        finally:
            opt_state["learning_rate"] = lr

    monkeypatch.setattr(state.Optimizer, "update", update)
    out = run(tiny, name)
    assert out["correct"] is False
    checks = out["checks"]
    grad = checks["worst_tensor_grad_gap"]
    assert grad["value"] <= grad["limit"]
    assert checks["median_change_gap"]["value"] > 0.5


@pytest.mark.parametrize("name,fn", [
    ("coordgridnet_train_b32", "train.steps.decode_batch"),
    ("gridnet_recipe_k4_b32", "train.multistep.decode_window_batch")])
def test_half_of_the_batch_left_out(tiny, name, fn, monkeypatch):
    import importlib
    mod_name, attr = fn.rsplit(".", 1)
    mod = importlib.import_module("video_layout_generation_tpu_torch."
                                  + mod_name)
    real = getattr(mod, attr)

    def first_half(batch):
        return real({k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(mod, attr, first_half)
    assert run(tiny, name)["correct"] is False


@pytest.mark.parametrize("name", ["gridnet_rollout_b16", "gridnet_rollout_b1"])
@pytest.mark.parametrize("what", ["layout", "frame"])
def test_an_answer_altered_where_it_is_produced(tiny, name, what,
                                                monkeypatch):
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    real = LayoutPredictor._decode_out

    def altered(self, out):
        frames, layouts = real(self, out)
        frames, layouts = frames.copy(), layouts.copy()
        if what == "layout":
            layouts[0, -1, 5, 7] = (layouts[0, -1, 5, 7] + 1) % 20
        else:
            frames[0, -1, 5, 7, 1] = 1.0 - frames[0, -1, 5, 7, 1]
        return frames, layouts

    monkeypatch.setattr(LayoutPredictor, "_decode_out", altered)
    out = run(tiny, name)
    assert out["correct"] is False
    key = "layout_gap" if what == "layout" else "frame_err"
    assert out["checks"][key]["value"] > out["checks"][key]["limit"]


@pytest.mark.parametrize("name", ["coordgridnet_train_b32",
                                  "gridnet_recipe_k4_b32"])
def test_the_float8_control_fails_a_train_cell(tiny, name):
    cell = harness.load_cell(tiny, name)
    mod = harness.driver_module(cell)
    drv = mod.Driver(cell, SEED, "cpu")
    drv.setup()
    drv.release()
    got = control.train_readings(drv, mod)
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    assert any(v > cell.limits[k] for k, v in got["control"].items())
    assert any(v > cell.limits[k] for k, v in got["half_batch"].items())


@pytest.mark.parametrize("name", ["gridnet_rollout_b16", "gridnet_rollout_b1"])
def test_the_float8_control_fails_a_rollout_cell(tiny, name):
    cell = harness.load_cell(tiny, name)
    mod = harness.driver_module(cell)
    drv = mod.Driver(cell, SEED, "cpu")
    drv.setup()
    drv.window(0.3)
    drv.release()
    got = control.rollout_readings(drv, mod)
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    assert any(v > cell.limits[k] for k, v in got["control"].items())
    assert any(v > cell.limits[k] for k, v in got["altered"].items())
    assert np.isfinite(list(got["control"].values())).all()
