"""The plain reference imports nothing of JAX or of the port, and agrees
with the port's plain float32 path at 32 x 32: nets alone, a whole train
step (K = 1 and the K-step recipe) and a rollout through the harness."""

import ast
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import nets

ROOT = Path(__file__).resolve().parents[2]
PORT = "video_layout_generation_tpu_torch"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_port(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & (set(harness.FORBIDDEN) | {PORT})


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "benchmark").rglob("*.py")), ids=lambda p: p.name)
def test_no_benchmark_file_imports_jax(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


def _weights(spec, gain, seed=7):
    return weights.make(spec, seed, "gen", gain, {}, "cpu")


@pytest.mark.parametrize("coord", [False, True])
def test_gridnet_against_the_port(coord):
    from video_layout_generation_tpu_torch.models import CoordGridNet, GridNet
    spec = nets.gridnet_spec(10, (4, 6, 8), coord)
    w = _weights(spec, 1.0)
    port = (CoordGridNet if coord else GridNet)(n_channels=10,
                                                filters_level=(4, 6, 8))
    port.load_state_dict(w, strict=True)
    x = torch.randn(2, 32, 32, 10, generator=torch.Generator().manual_seed(1))
    seg, img = nets.gridnet(w, x)
    with torch.no_grad():
        pseg, pimg = port(x)
    torch.testing.assert_close(seg.permute(0, 2, 3, 1), pseg, atol=2e-5,
                               rtol=1e-5)
    torch.testing.assert_close(img.permute(0, 2, 3, 1), pimg, atol=2e-5,
                               rtol=1e-5)


def test_hned_and_vgg_against_the_port():
    from video_layout_generation_tpu_torch.losses import VGG19Features
    from video_layout_generation_tpu_torch.models import HNED, hned_fused_edge
    hw = _weights(nets.hned_spec(), 2.0)
    vw = _weights(nets.vgg_spec(), 2.0, seed=8)
    h, v = HNED(), VGG19Features()
    h.load_state_dict(hw, strict=True)
    v.load_state_dict(vw, strict=True)
    rgb = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(nets.hned_edge(hw, rgb),
                               hned_fused_edge(h, rgb), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        got = v(rgb)
    want = nets.vgg_features(vw, rgb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(want, got, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("name", ["coordgridnet_train_b32",
                                  "gridnet_recipe_k4_b32",
                                  "gridnet_rollout_b16", "gridnet_rollout_b1"])
def test_the_port_in_float32_passes_its_check(tiny, name):
    """The port's plain float32 path, run by the harness, against the
    reference: the tiny limits (``conftest.TINY_LIMITS``) are a hundredth
    of the bf16 cells' readings and pass only where both compute the same
    function."""
    out = harness.run_cell(tiny, name, 2 ** 31 + 11, 0.3, False, time.time(),
                           "cpu", log=lambda m: None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.load_cell(tiny, name).end_to_end}
