"""The port's rollout and LayoutPredictor on the CPU against the JAX
LayoutPredictor (f32, ``use_bf16=False``), plus the port's import and
device contracts.

Weights are made with numpy from a seed and handed to both predictors.
Frames are held at atol 1e-4 (f32 sums in another order, and the uint8
path's 1/255 steps coincide); layouts must be identical.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.serving import \
    LayoutPredictor as JaxPredictor
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train.rollout import make_rollout_fn
from video_layout_generation_tpu_torch.train.steps import make_train_step

from test_torch_gridnet import FILTERS, random_flax_params

HW = (32, 32)
KW = dict(n_frames=3, batch=4, image_hw=HW, filters_level=FILTERS,
          use_bf16=False)


@pytest.fixture(scope="module")
def params():
    model = jgrid.GridNet(n_channels=8, filters_level=FILTERS)
    return random_flax_params(model, (1,) + HW + (8,), seed=7)


def _request(n, seed=0):
    rng = np.random.default_rng(seed)
    img1, img2 = (rng.random((n,) + HW + (3,)).astype(np.float32)
                  for _ in range(2))
    seg1, seg2 = (rng.integers(0, 20, (n,) + HW) for _ in range(2))
    return img1, img2, seg1, seg2


@pytest.mark.parametrize("quantize,upsample", [(False, "bilinear"),
                                               (True, "bilinear"),
                                               (False, "nearest")])
def test_predict_matches_jax_predictor(params, quantize, upsample):
    kw = dict(KW, quantize_transfer=quantize, upsample=upsample)
    req = _request(2)
    fj, lj = JaxPredictor("GridNet", params, **kw).predict(*req)
    ft, lt = LayoutPredictor("GridNet", params, device="cpu",
                             **kw).predict(*req)
    assert ft.shape == (2, 3) + HW + (3,) and lt.shape == (2, 3) + HW
    assert ft.dtype == np.float32 and lt.dtype == np.int32
    np.testing.assert_allclose(ft, np.asarray(fj), atol=1e-4)
    np.testing.assert_array_equal(lt, np.asarray(lj))


def test_pipelined_and_many_equal_predict(params):
    pred = LayoutPredictor("GridNet", params, device="cpu",
                           **dict(KW, n_frames=1))
    reqs = [_request(4, seed=1), _request(3, seed=2)]
    singles = [pred.predict(*r) for r in reqs]
    for (f, l), (fs, ls) in zip(pred.predict_pipelined(iter(reqs),
                                                       depth=2), singles):
        np.testing.assert_array_equal(f, fs)
        np.testing.assert_array_equal(l, ls)
    both = [np.concatenate(a) for a in zip(*reqs)]
    f, l = pred.predict_many(*both)
    np.testing.assert_array_equal(f, np.concatenate([s[0] for s in singles]))
    np.testing.assert_array_equal(l, np.concatenate([s[1] for s in singles]))
    with pytest.raises(ValueError, match="depth"):
        pred.predict_pipelined(iter(reqs), depth=0)


def test_cpu_predictor_never_captures(params):
    """CUDA graphs only on a card with the kernels: on the CPU every request
    runs eagerly, the second and later ones of a shape too, and a request
    served again gets the same answer."""
    pred = LayoutPredictor("GridNet", params, device="cpu",
                           **dict(KW, n_frames=2))
    reqs = [_request(2, seed=3), _request(4, seed=4), _request(2, seed=3)]
    outs = [pred.predict(*r) for r in reqs]
    assert pred.rollouts == {"replayed": 0, "eager": 3, "captured": 0}
    assert all(rep.graphs == {} and rep.stream is None
               for rep in pred._replicas)
    np.testing.assert_array_equal(outs[0][0], outs[2][0])
    np.testing.assert_array_equal(outs[0][1], outs[2][1])


def test_predict_rejects_oversized_batch(params):
    pred = LayoutPredictor("GridNet", params, device="cpu",
                           **dict(KW, batch=2, n_frames=1))
    with pytest.raises(ValueError, match="shard the request"):
        pred.predict(*_request(3))


def test_unported_options_raise(params):
    # the mesh is ported: a batch it cannot split raises the JAX message
    from video_layout_generation_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="divisible by the mesh size 3"):
        LayoutPredictor("GridNet", params, device="cpu",
                        mesh=make_mesh(["cpu"] * 3), **dict(KW, batch=2))
    # checkpoints are ported: a missing one is now simply not found
    with pytest.raises(FileNotFoundError):
        LayoutPredictor.from_checkpoint("/nonexistent")
    # the train step takes GridNet too: kernels A and B differentiate
    # through the library's VJP
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    from video_layout_generation_tpu_torch.models import GridNet
    assert callable(make_train_step(
        GridNet(n_channels=8, filters_level=FILTERS), None,
        CombinedLoss.create(device="cpu"), device="cpu"))
    with pytest.raises(ValueError, match="GridNet"):
        LayoutPredictor("UNet", params, device="cpu", **KW)
    # edge mode is ported; what it still refuses is a missing edge net
    with pytest.raises(ValueError, match="HNED"):
        LayoutPredictor("GridNet", params, device="cpu", use_edges=True,
                        **KW)
    with pytest.raises(ValueError, match="HNED"):
        make_rollout_fn(lambda x: x, use_edges=True)


def test_default_device_is_cuda_and_raises_without_one(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LayoutPredictor("GridNet", params, **KW)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import video_layout_generation_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
        "assert 'video_layout_generation_tpu' not in sys.modules\n"
        "print(*sorted(k[len(pkg.__name__) + 1:] for k in sys.modules "
        "if k.startswith(pkg.__name__ + '.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 80
    assert {"val", "models.legacy", "io.torch_reader", "ops.boxes", "utils",
            "utils.trees", "utils.profiling"} <= imported
    assert {"train.multistep", "train.scheduled",
            "data.device_synthetic"} <= imported
    assert {"parallel", "parallel.mesh", "parallel.collectives",
            "io.native_loader"} <= imported
    assert {"config", "main", "runner", "data", "data.index", "data.stats",
            "data.synthetic", "data.cityscapes", "data.pipeline",
            "io.checkpoint", "io.logging", "io.tb", "utils.meters",
            "ops.colorize", "ops.one_hot", "evaluation.export",
            "evaluation.sequence"} <= imported
    assert {"ops.kernels.instance_norm", "models.norms", "models.init",
            "models.layers", "models.resnet_gen", "models.unet_gen",
            "models.discriminators", "models.factories", "losses.gan",
            "train.state", "train.schedules", "train.gan"} <= imported
    assert {"serving", "device", "train.rollout", "train.steps", "train.trainer",
            "models.gridnet", "models.hned", "losses.ssim", "losses.pixel",
            "losses.ce", "losses.vgg", "losses.combined", "ops.pooling",
            "ops.resize", "ops.kernels.ssim", "ops.kernels.conv3x3",
            "ops.kernels.lateral", "evaluation.metrics",
            "io.weights"} <= imported


def test_chip_smoke_imports_no_jax():
    """The on-card script names no JAX package in its imports."""
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "flax", "optax", "orbax",
                        "video_layout_generation_tpu"}
    assert "video_layout_generation_tpu_torch" in roots
