"""The port's GridNet / CoordGridNet forward, weight bridge and small ops
against the JAX package, on the CPU in f32.

Weights are made with numpy from a seed in the shapes of the flax tree and
handed to both packages (the port through ``params_from_flax``), so both
compute from the same numbers. Tolerance atol 1e-4 at narrow widths; the
full-width trained snapshot (flagship_096) is held at atol 1e-3, its
activations being larger.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.ops import coords as jcoords
from video_layout_generation_tpu.ops import resize as jresize
from video_layout_generation_tpu.train import assemble as jasm
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import get_model_cls
from video_layout_generation_tpu_torch.ops import coords as tcoords
from video_layout_generation_tpu_torch.ops import resize as tresize
from video_layout_generation_tpu_torch.train import assemble as tasm

FILTERS = (4, 6, 8)
SNAPSHOT = Path(__file__).resolve().parents[1] / "artifacts_store" / \
    "flagship_096.npz"


def random_flax_params(model, x_shape, seed=0):
    """Numpy weights in the shapes of ``model``'s flax tree: lecun-scaled
    kernels, small random biases, PReLU slopes in [0.05, 0.45)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = s.shape[0] * s.shape[1] * s.shape[2]
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.uniform(0.05, 0.45, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(arch, params, **kw):
    model = get_model_cls(arch)(**kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("arch,n_channels", [("GridNet", 8),
                                             ("GridNet", 10),
                                             ("CoordGridNet", 10)])
def test_gridnet_forward_matches_flax(arch, n_channels):
    jmodel = getattr(jgrid, arch)(n_channels=n_channels,
                                  filters_level=FILTERS)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, 32, n_channels)).astype(np.float32)
    params = random_flax_params(jmodel, x.shape)
    seg_j, img_j = jmodel.apply(params, jnp.asarray(x))
    tmodel = port_model(arch, params, n_channels=n_channels,
                        filters_level=FILTERS)
    with torch.inference_mode():
        seg_t, img_t = tmodel(torch.from_numpy(x))
    assert seg_t.shape == (2, 32, 32, 20) and img_t.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j),
                               atol=1e-4, rtol=1e-4)


def test_full_width_flagship_snapshot_matches_flax():
    flat = np.load(SNAPSHOT)
    tree = {}
    for key in flat.files:
        if key.startswith("__"):
            continue
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(flat[key])
    x = np.random.default_rng(2).standard_normal(
        (1, 32, 32, 10)).astype(np.float32)
    seg_j, img_j = jgrid.GridNet(n_channels=10).apply(tree, jnp.asarray(x))
    tmodel = port_model("GridNet", flat, n_channels=10)
    with torch.inference_mode():
        seg_t, img_t = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), atol=1e-3)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-3)


def test_bridge_takes_tree_variables_and_flat_forms_alike():
    jmodel = jgrid.GridNet(n_channels=8, filters_level=FILTERS)
    params = random_flax_params(jmodel, (1, 8, 8, 8), seed=3)
    flat = {}

    def add(path, leaf):
        flat["/".join(p.key for p in path)] = np.asarray(leaf)

    jax.tree_util.tree_map_with_path(add, params)
    flat["__epoch__"] = np.asarray(3)
    a = params_from_flax(params)
    b = params_from_flax(params["params"])
    c = params_from_flax(flat)
    d = params_from_flax(a)     # a state dict passes through
    assert a.keys() == b.keys() == c.keys() == d.keys()
    assert "col_1.down_01.Conv_0.kernel" in a
    for k in a:
        assert torch.equal(a[k], c[k]) and torch.equal(a[k], d[k])
    # one to one with the port's modules
    tmodel = get_model_cls("GridNet")(n_channels=8, filters_level=FILTERS)
    assert set(tmodel.state_dict()) == set(a)


def test_bridge_reads_bf16_snapshot_entries():
    vals = np.array([1.0, -2.5, 0.15625], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype(np.uint16).view("V2")
    out = params_from_flax({"params/x/alpha::bfloat16": raw})
    assert torch.equal(out["x.alpha"], torch.from_numpy(vals))


@pytest.mark.parametrize("h,w", [(4, 4), (5, 8), (1, 3)])
def test_upsample_bilinear_align_matches_jax(h, w):
    x = np.random.default_rng(4).standard_normal((2, h, w, 3)).astype(
        np.float32)
    ref = jresize.upsample2x_bilinear_align(jnp.asarray(x))
    got = tresize.upsample2x_bilinear_align(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_upsample_nearest_repeats_each_pixel():
    x = torch.arange(6.0).reshape(1, 2, 3, 1)
    y = tresize.upsample2x(x, "nearest")
    ref = jnp.repeat(jnp.repeat(jnp.asarray(x.numpy()), 2, 1), 2, 2)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="upsample"):
        tresize.upsample2x(x, "bicubic")


def test_coord_grid_matches_jax():
    x = np.zeros((2, 5, 7, 3), np.float32)
    ref = jcoords.add_coord_channels(jnp.asarray(x))
    got = tcoords.add_coord_channels(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)


def test_assemble_and_normalization_match_jax():
    rng = np.random.default_rng(5)
    f1, f2 = (rng.random((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    s1, s2, e1, e2 = (rng.random((2, 4, 4, 1)).astype(np.float32)
                      for _ in range(4))
    for name in ("normalize_image", "denormalize_image",
                 "normalize_model_output"):
        np.testing.assert_allclose(
            getattr(tasm, name)(torch.from_numpy(f1)).numpy(),
            np.asarray(getattr(jasm, name)(jnp.asarray(f1))), atol=1e-6)
    t = [torch.from_numpy(a) for a in (s1, f1, f2, s2)]
    j = [jnp.asarray(a) for a in (s1, f1, f2, s2)]
    np.testing.assert_array_equal(tasm.assemble_model_input(*t).numpy(),
                                  np.asarray(jasm.assemble_model_input(*j)))
    np.testing.assert_array_equal(
        tasm.assemble_model_input(*t, torch.from_numpy(e1),
                                  torch.from_numpy(e2)).numpy(),
        np.asarray(jasm.assemble_model_input(*j, jnp.asarray(e1),
                                             jnp.asarray(e2))))
