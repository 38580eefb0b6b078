"""The port's last utilities against the JAX package's: ``ops/boxes.py``
``mask2box``, ``ops/resize.py`` ``resize_nearest`` / ``interp_matrix``,
``utils/trees.py`` and ``utils/profiling.py``; and the package surface:
the model registry and every name a JAX package ``__init__`` exports."""

import ast
import glob
import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.models.legacy import Simple as JSimple
from video_layout_generation_tpu.ops.boxes import mask2box as jmask2box
from video_layout_generation_tpu.ops.resize import (
    interp_matrix as jinterp_matrix, resize_nearest as jresize_nearest)
from video_layout_generation_tpu.utils.trees import (
    param_count as jparam_count, tree_cast as jtree_cast)
from video_layout_generation_tpu_torch import models
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models.legacy import Simple
from video_layout_generation_tpu_torch.ops import (interp_matrix, mask2box,
                                                   resize_nearest)
from video_layout_generation_tpu_torch.utils import (Throughput, annotate,
                                                     param_count, trace,
                                                     tree_cast)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# JAX package names with no counterpart in the port, each named in the
# docstring of the port's package (or module) that leaves it out
TPU_ONLY = {
    "parallel": ("batch_sharding", "replicated_sharding"),
    "data": ("ShardedLoader",),
    "models": ("make_packed_gridnet_apply", "make_edge_rollout_apply"),
    "ops.resize": ("upsample2x_phases", "upsample2x_bilinear_align_stencil",
                   "upsample2x_align_to_1x2"),
}


def test_mask2box_matches_jax():
    rng = np.random.default_rng(0)
    masks = np.ones((5, 12, 20), np.float32)
    for i in range(3):
        y0, x0 = rng.integers(0, 6), rng.integers(0, 10)
        masks[i, y0:y0 + rng.integers(1, 6), x0:x0 + rng.integers(1, 10)] = 0
    masks[3, 4, 7] = 0                      # one pixel
    # masks[4]: no inner region -> the empty box [H, W, -1, -1]
    got = mask2box(torch.from_numpy(masks))
    want = np.asarray(jmask2box(jnp.asarray(masks)))
    assert got.dtype == torch.int32 and got.shape == (5, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[4].numpy(), [12, 20, -1, -1])


@pytest.mark.parametrize("out_hw", [(24, 40), (5, 7), (12, 20)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_resize_nearest_matches_jax(out_hw, dtype):
    rng = np.random.default_rng(1)
    x = (rng.random((2, 12, 20, 3)) * 200).astype(dtype)
    got = resize_nearest(torch.from_numpy(x), out_hw)
    want = np.asarray(jresize_nearest(jnp.asarray(x), out_hw))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method,align", [("nearest", False),
                                          ("bilinear", False),
                                          ("bilinear", True)])
@pytest.mark.parametrize("sizes", [(7, 16), (16, 7), (1, 5), (9, 1)])
def test_interp_matrix_matches_jax(method, align, sizes):
    got = interp_matrix(*sizes, method, align)
    want = np.asarray(jinterp_matrix(*sizes, method, align))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_interp_matrix_refuses_unknown_method():
    with pytest.raises(ValueError, match="unknown resize method"):
        interp_matrix(4, 8, "bicubic")


def test_param_count_and_tree_cast_match_jax():
    mask = np.zeros((1, 16, 16), np.float32)
    seg = np.zeros((1, 16, 16), np.int32)
    img = np.zeros((1, 16, 16, 3), np.float32)
    variables = jax.jit(JSimple(29, 15, "u_net").init)(
        jax.random.key(0), mask, seg, img)
    state = params_from_flax(variables)
    model = Simple(29, 15, "u_net")
    model.load_state_dict(state, strict=True)
    assert param_count(state) == jparam_count(variables)
    assert param_count(model) == jparam_count(variables["params"])
    assert param_count(model.state_dict()) == jparam_count(variables)

    tree = {"w": state["layer.outc.kernel"], "nested": {
        "b": state["layer.outc.bias"],
        "step": torch.tensor([3, 4], dtype=torch.int32)}}
    jtree = {"w": variables["params"]["layer"]["outc"]["kernel"],
             "nested": {"b": variables["params"]["layer"]["outc"]["bias"],
                        "step": jnp.asarray([3, 4], jnp.int32)}}
    got = tree_cast(tree, torch.bfloat16)
    want = jtree_cast(jtree, jnp.bfloat16)
    assert got["w"].dtype == torch.bfloat16
    assert got["nested"]["step"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"], np.float32))
    np.testing.assert_array_equal(got["nested"]["b"].float().numpy(),
                                  np.asarray(want["nested"]["b"], np.float32))
    np.testing.assert_array_equal(got["nested"]["step"].numpy(), [3, 4])
    cast = tree_cast(model, torch.float16)
    assert set(cast) == {k for k, _ in model.named_parameters()}
    assert all(v.dtype == torch.float16 for v in cast.values())


def test_trace_writes_the_annotation(tmp_path):
    with trace(str(tmp_path)):
        with annotate("vlg_port_annotation"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(ev.get("name") == "vlg_port_annotation" for ev in events)


def test_throughput_counts_items_per_second():
    t = Throughput()
    assert t.update(8) == 0.0
    assert t.update(8) > 0.0


def test_registry_resolves_the_jax_names():
    assert models.get_model_cls("HNED") is models.HNED
    for name in ("UNet", "EncoderDecoder", "simple29_unet",
                 "simple29_encoderdecoder"):
        assert models.get_model_cls(name) is getattr(models, name)
    assert isinstance(models.get_model_cls("simple29_unet")(), models.Simple)
    with pytest.raises(KeyError):
        models.get_model_cls("nope")


def _exported(package: str):
    """The names a JAX package ``__init__`` imports, with their module."""
    src = (ROOT / "video_layout_generation_tpu" / package /
           "__init__.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for alias in node.names:
                yield node.module, alias.asname or alias.name


@pytest.mark.parametrize("package", ["ops", "io", "utils", "train",
                                     "evaluation", "models", "losses",
                                     "data", "parallel"])
def test_package_exports_match_jax(package):
    """Each name of the JAX package's ``__init__`` is exported by the
    port's, or it is TPU-only and the port's docstring names it."""
    port = importlib.import_module(
        f"video_layout_generation_tpu_torch.{package}")
    for module, name in _exported(package):
        skipped = [k for k, names in TPU_ONLY.items() if name in names]
        if skipped:
            doc_of = skipped[0]
            doc = importlib.import_module(
                f"video_layout_generation_tpu_torch.{doc_of}").__doc__
            assert name in doc, (package, name)
            assert not hasattr(port, name), (package, name)
            continue
        assert name in port.__all__, (package, name)
        assert getattr(port, name) is not None, (package, name)
    for doc_of, names in TPU_ONLY.items():
        doc = importlib.import_module(
            f"video_layout_generation_tpu_torch.{doc_of}").__doc__
        assert all(n in doc for n in names), doc_of
