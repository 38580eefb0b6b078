"""The port's kernel A (prelu_conv3x3) and kernel B (fused_lateral), run
through their plain PyTorch versions on CPU tensors, against the JAX
package's Pallas kernels in interpret mode.

The JAX side takes the 2x2 (or 1x2) packed inputs its kernels were written
for (pack2x2 / pack_kernel3x3) and its output is unpacked; the port takes
the logical NHWC tensors. Everything is f32: the point is the function,
not the rounding. Tolerance atol 1e-4, rtol 1e-4 (f32 sums in another
order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video_layout_generation_tpu.ops.packed import (conv_packed_stride2,
                                                    pack2x2, pack_kernel3x3,
                                                    pack_kernel3x3_stride2,
                                                    unpack2x2)
from video_layout_generation_tpu.ops.pallas import conv_packed
from video_layout_generation_tpu.ops.pallas.conv1x2 import conv3x3_w1x2
from video_layout_generation_tpu.ops.pallas.conv3x3 import conv3x3_pallas
from video_layout_generation_tpu_torch.ops.kernels import (
    fused_lateral, launch_counts, prelu_conv3x3, reset_launch_counts)

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_a(x, w, b, alpha=None, residual=None, stride=1):
    out = prelu_conv3x3(_t(x), _t(w), _t(b),
                        None if alpha is None else torch.tensor(alpha),
                        None if residual is None else _t(residual), stride)
    return out.numpy()


@pytest.mark.parametrize("mode", ["sparse", "prelu", "prelu_res"])
def test_kernel_a_matches_conv_packed(interp, mode):
    c = 32
    x = _rand(2, 16, 16, c, seed=1)
    w = _rand(3, 3, c, c, seed=2, scale=0.05)
    b = _rand(c, seed=3)
    r = _rand(2, 16, 16, c, seed=4)
    alpha = 0.2
    xp, wp = pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w))
    jb, ja = jnp.asarray(b), jnp.asarray(alpha, jnp.float32)
    if mode == "sparse":
        ref = conv_packed.conv_packed3x3_sparse(xp, wp, jb, 4)
        got = _port_a(x, w, b)
    elif mode == "prelu":
        ref = conv_packed.prelu_conv_packed3x3(xp, wp, jb, ja, 4)
        got = _port_a(x, w, b, alpha)
    else:
        ref = conv_packed.prelu_conv_packed3x3_res(
            xp, wp, jb, ja, pack2x2(jnp.asarray(r)), 4)
        got = _port_a(x, w, b, alpha, r)
    np.testing.assert_allclose(got, np.asarray(unpack2x2(ref)), **TOL)


def test_kernel_a_matches_conv1x2(interp):
    x = _rand(1, 8, 16, 64, seed=5)
    w = _rand(3, 3, 64, 64, seed=6, scale=0.05)
    b = _rand(64, seed=7)
    ref = conv3x3_w1x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4)
    np.testing.assert_allclose(_port_a(x, w, b), np.asarray(ref), **TOL)


def test_kernel_a_matches_conv3x3_pallas(interp):
    x = _rand(1, 8, 8, 128, seed=8)
    w = _rand(3, 3, 128, 128, seed=9, scale=0.05)
    b = _rand(128, seed=10)
    ref = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4)
    np.testing.assert_allclose(_port_a(x, w, b), np.asarray(ref), **TOL)


def test_kernel_a_stride2_matches_packed_stride2():
    # DownSamplingBlock.Conv_0: the JAX package runs it as a VALID conv on
    # the packed row-0 tensor (XLA; no Pallas kernel)
    x = _rand(2, 16, 16, 32, seed=11)
    w = _rand(3, 3, 32, 64, seed=12, scale=0.05)
    b = _rand(64, seed=13)
    ref = conv_packed_stride2(pack2x2(jnp.asarray(x)),
                              pack_kernel3x3_stride2(jnp.asarray(w)),
                              jnp.asarray(b))
    got = _port_a(x, w, b, stride=2)
    assert got.shape == (2, 8, 8, 64)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_residual", [False, True])
def test_kernel_b_matches_fused_lateral(interp, with_residual):
    c = 32
    x = _rand(2, 16, 16, c, seed=14)
    w0 = _rand(3, 3, c, c, seed=15, scale=0.2)
    w1 = _rand(3, 3, c, c, seed=16, scale=0.2)
    b0 = _rand(c, seed=17, scale=0.1)
    b1 = _rand(c, seed=18, scale=0.1)
    r = _rand(2, 16, 16, c, seed=19) if with_residual else None
    a0, a1 = 0.25, 0.1
    ref = conv_packed.fused_lateral_packed3x3(
        pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w0)),
        jnp.asarray(b0), jnp.asarray(a0), pack_kernel3x3(jnp.asarray(w1)),
        jnp.asarray(b1), jnp.asarray(a1),
        None if r is None else pack2x2(jnp.asarray(r)), tile_h=2)
    got = fused_lateral(_t(x), _t(w0), _t(b0), torch.tensor(a0), _t(w1),
                        _t(b1), torch.tensor(a1),
                        None if r is None else _t(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack2x2(ref)),
                               **TOL)


@pytest.mark.parametrize("ci,co", [(8, 32), (12, 32), (32, 20), (32, 3)])
def test_kernel_a_gridnet_edge_widths(ci, co):
    # input stems (8, 10+2 coordinate channels) and the two heads
    x = _rand(1, 8, 8, ci, seed=20)
    w = _rand(3, 3, ci, co, seed=21, scale=0.1)
    b = _rand(co, seed=22)
    xn = np.where(x >= 0, x, 0.3 * x)
    ref = torch.nn.functional.conv2d(
        _t(xn).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1), _t(b),
        padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_port_a(x, w, b, 0.3), ref.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    reset_launch_counts()
    x = torch.zeros(1, 4, 4, 8)
    prelu_conv3x3(x, torch.zeros(3, 3, 8, 8), torch.zeros(8))
    assert launch_counts() == {"prelu_conv3x3": 0, "fused_lateral": 0,
                               "ssim_loss": 0, "instance_norm_fwd": 0,
                               "instance_norm_fwd_only": 0,
                               "instance_norm_bwd": 0}


def test_kernel_a_rejects_other_strides():
    with pytest.raises(ValueError, match="stride"):
        prelu_conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8),
                      torch.zeros(8), stride=3)
