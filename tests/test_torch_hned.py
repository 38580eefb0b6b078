"""The port's HNED edge net, bilinear resize and pooling on the CPU in f32
against the JAX package.

HNED runs with the committed ``hned_synth.npz`` weights in both packages;
frames are made with numpy from a seed. Edge maps are sigmoid outputs in
[0, 1] and are held at atol 1e-4 (13 f32 convs summed in another order);
resizes and pools at atol 1e-5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.io import weights as jweights
from video_layout_generation_tpu.models import hned as jhned
from video_layout_generation_tpu.ops import pooling as jpool
from video_layout_generation_tpu.ops import resize as jresize
from video_layout_generation_tpu_torch.io.weights import (load_hned_params,
                                                          params_from_flax)
from video_layout_generation_tpu_torch.models import HNED, hned_fused_edge
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.ops import pooling as tpool
from video_layout_generation_tpu_torch.ops import resize as tresize

HNED_NPZ = str(Path(__file__).resolve().parents[1] / "artifacts_store"
               / "hned_synth.npz")


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((4, 6), (16, 12)),     # up
                                          ((32, 32), (16, 16)),   # down x2
                                          ((9, 14), (4, 5)),      # down, odd
                                          ((2, 2), (32, 32)),     # HNED stage 5
                                          ((1, 3), (4, 1)),
                                          ((8, 8), (8, 8))])
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    x = _rand(2, *in_hw, 3, seed=1)
    ref = jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners)
    got = tresize.resize_bilinear(torch.from_numpy(x), out_hw, align_corners)
    assert got.shape == (2,) + out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_resize_bilinear_half_pixel_is_torch_interpolate():
    x = _rand(1, 6, 10, 2, seed=2)
    for out_hw in ((12, 20), (3, 5)):
        ref = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        got = tresize.resize_bilinear(torch.from_numpy(x), out_hw, False)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_resize_bilinear_keeps_dtype_and_leading_dims():
    x = torch.from_numpy(_rand(2, 3, 4, 4, 1, seed=3)).to(torch.bfloat16)
    y = tresize.resize_bilinear(x, (8, 8))
    assert y.shape == (2, 3, 8, 8, 1) and y.dtype == torch.bfloat16
    assert y.is_contiguous()


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 9, 4), (3, 2, 6, 6, 2)])
def test_pooling_matches_jax(shape):
    x = _rand(*shape, seed=4)
    np.testing.assert_array_equal(
        tpool.max_pool_2x2(torch.from_numpy(x)).numpy(),
        np.asarray(jpool.max_pool_2x2(jnp.asarray(x))))
    np.testing.assert_allclose(
        tpool.avg_pool_3x3_valid(torch.from_numpy(x)).numpy(),
        np.asarray(jpool.avg_pool_3x3_valid(jnp.asarray(x))), atol=1e-5)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("assume_bgr_input", [False, True])
def test_hned_six_maps_match_flax_with_synth_weights(frames,
                                                     assume_bgr_input):
    jparams = jweights.load_hned_params(HNED_NPZ)
    ref = jhned.HNED(assume_bgr_input=assume_bgr_input).apply(
        jparams, jnp.asarray(frames))
    model = HNED(assume_bgr_input=assume_bgr_input)
    model.load_state_dict(load_hned_params(HNED_NPZ), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.shape == (2, 32, 32, 1) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    # the two channel orders give different edges: the flip is real
    other = HNED(assume_bgr_input=not assume_bgr_input)
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert float((other(torch.from_numpy(frames))[-1]
                      - got[-1]).abs().max()) > 1e-4


def test_hned_fused_edge_and_bridge_forms(frames):
    jparams = jweights.load_hned_params(HNED_NPZ)
    ref = jhned.hned_fused_edge(jhned.HNED(), jparams, jnp.asarray(frames))
    from_file = load_hned_params(HNED_NPZ)
    from_tree = params_from_flax(jparams)
    assert len(from_file) == 38 and from_file.keys() == from_tree.keys()
    for k in from_file:
        assert torch.equal(from_file[k], from_tree[k])
    model = HNED()
    assert set(model.state_dict()) == set(from_file)
    model.load_state_dict(from_tree, strict=True)
    x = torch.from_numpy(frames).requires_grad_(True)
    kernels.reset_launch_counts()
    edge = hned_fused_edge(model, x)
    assert not edge.requires_grad          # frozen: no gradient flows
    assert kernels.launch_counts()["prelu_conv3x3"] == 0   # CPU: plain
    np.testing.assert_allclose(edge.numpy(), np.asarray(ref), atol=1e-4)
    with kernels.plain():
        plain = hned_fused_edge(model, x)
    np.testing.assert_array_equal(edge.numpy(), plain.numpy())


def test_hned_bf16_trunk_stays_close_to_f32(frames):
    model = HNED()
    model.load_state_dict(load_hned_params(HNED_NPZ))
    low = HNED(dtype=torch.bfloat16)
    low.load_state_dict(model.state_dict())
    x = torch.from_numpy(frames)
    a, b = hned_fused_edge(model, x), hned_fused_edge(low, x)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.05
