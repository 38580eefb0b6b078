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
from video_layout_generation_tpu_torch.parallel import make_mesh
from video_layout_generation_tpu_torch.parallel.mesh import shard_batch
from video_layout_generation_tpu_torch import serving
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train.assemble import \
    denormalize_image
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


def _pack_before_staging(pred, img1, img2, seg1, seg2):
    """The request packed as before staging buffers: one fresh array, each
    input padded to the batch by its last example, then concatenated."""
    n = img1.shape[0]

    def pad(x):
        if x.shape[0] == pred.batch:
            return x
        return np.concatenate(
            [x, np.repeat(x[-1:], pred.batch - x.shape[0], axis=0)])

    x = np.concatenate(
        [pad(np.asarray(img1, np.float32)),
         pad(np.asarray(img2, np.float32)),
         pad(np.asarray(seg1, np.float32))[..., None],
         pad(np.asarray(seg2, np.float32))[..., None]], axis=-1)
    if pred.quantize_transfer:
        x = np.concatenate(
            [x[..., 0:6] * 255.0 + 0.5, x[..., 6:8]],
            axis=-1).astype(np.uint8)
    return x, n


@torch.inference_mode()
def _predict_before_staging(pred, *req):
    """``predict`` as before staging buffers, on the CPU: the packed array
    up, one packed array (frames and f32 ids, or uint8) back, decoded on
    the host."""
    x, n = _pack_before_staging(pred, *req)
    shards = ([torch.from_numpy(x)] if pred.mesh is None
              else [sh["x"] for sh in shard_batch({"x": x}, pred.mesh)])
    outs = [rep.run(part)[0] for rep, part in zip(pred._replicas, shards)]
    imgs, segs = (torch.cat([o[j] for o in outs]) for j in (0, 1))
    f = denormalize_image(imgs[:n]).clamp(0.0, 1.0)
    lay = segs[:n]
    if pred.quantize_transfer:
        out = torch.cat([(f * 255.0 + 0.5).to(torch.uint8),
                         lay.to(torch.uint8)], dim=-1).numpy()
        frames = out[..., :3].astype(np.float32) / 255.0
    else:
        out = torch.cat([f, lay], dim=-1).numpy()
        frames = out[..., :3]
    return frames, out[..., 3].astype(np.int32)


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["calling_thread", "intra_op_threads"])
@pytest.mark.parametrize("devices", [1, 2], ids=["no_mesh", "mesh2"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("n", [4, 3], ids=["full", "padded"])
def test_staged_requests_equal_the_packed_path(params, n, quantize, devices,
                                               threaded, monkeypatch):
    """Requests of one shape share one staging set: each is packed into its
    upload buffer byte for byte as the one packed array was, and its
    frames and layouts equal the packed path's in value, dtype and shape,
    in fresh arrays that later requests leave as they were; with the host
    copies on the calling thread (every copy at this size) and on the
    intra-op threads (a large request's)."""
    if threaded:
        monkeypatch.setattr(serving, "_THREADED_COPY_BYTES", 0)
    mesh = make_mesh(["cpu"] * 2) if devices == 2 else None
    pred = LayoutPredictor("GridNet", params, device="cpu", mesh=mesh,
                           **dict(KW, n_frames=2, quantize_transfer=quantize))
    answers = []
    for seed in (10, 11, 12):
        req = _request(n, seed)
        if seed == 12:   # views with a negative stride
            req = tuple(np.flip(a, axis=1) for a in req)
        got = pred.predict(*req)
        (st,) = pred._staging.values()
        packed, _ = _pack_before_staging(pred, *req)
        staged = st.x.numpy()
        assert staged.dtype == packed.dtype and staged.shape == packed.shape
        assert staged.tobytes() == packed.tobytes()
        want = _predict_before_staging(pred, *req)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            assert not any(np.shares_memory(a, buf.numpy())
                           for buf in (st.x, st.frames, st.layouts))
        answers.append((got, [a.copy() for a in got]))
    for got, copies in answers:
        for a, b in zip(got, copies):
            assert a.tobytes() == b.tobytes()
    assert pred.staging == {"staged": 3, "buffers": 1}
    assert pred.rollouts == {"replayed": 0, "eager": 3, "captured": 0}


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
