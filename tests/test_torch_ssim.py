"""The port's fused SSIM loss, run through its plain PyTorch version on CPU
tensors, against the JAX package: the XLA formula of ``losses/ssim.py`` and
the Pallas kernel ``ops/pallas/ssim.py:_ssim_pallas_fwd_impl`` in interpret
mode.

Inputs are made with numpy from a seed and handed to both. f32 values are
held at atol 1e-6 (f32 sums in another order; per-plane values lie in
[0, 1]), gradients at atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video_layout_generation_tpu.losses.ssim import ssim_loss as jax_ssim
from video_layout_generation_tpu.ops.pallas import ssim as jax_kernel
from video_layout_generation_tpu_torch.losses.ssim import ssim_loss
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.ops.kernels import ssim as tk


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 0.2 + 0.5, 0, 1)
    y = np.clip(x + noise * rng.standard_normal(shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 9, 21, 3),
                                   (1, 3, 3, 1), (2, 32, 32, 5)])
@pytest.mark.parametrize("kernel", [False, True])
def test_ssim_loss_matches_xla_formula(shape, kernel):
    """A differentiated call takes the plain formula, one under no_grad the
    kernel's wrapper."""
    x, y = _pair(shape, seed=1)
    ref = float(jax_ssim(jnp.asarray(x), jnp.asarray(y), use_pallas=False))
    xt = torch.from_numpy(x).requires_grad_(not kernel)
    with torch.set_grad_enabled(not kernel):
        got = ssim_loss(xt, torch.from_numpy(y))
    assert got.requires_grad == (not kernel)
    assert abs(float(got) - ref) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 24, 8, 3)])
def test_ssim_matches_pallas_kernel_interpret(interp, shape):
    x, y = _pair(shape, seed=2)
    ref = float(jax_kernel._ssim_pallas_fwd_impl(jnp.asarray(x),
                                                 jnp.asarray(y)))
    got = float(tk.ssim_loss(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - ref) <= 1e-6


def test_ssim_planes_shape_and_sum_contract():
    x, y = _pair((3, 12, 10, 3), seed=3)
    planes = tk.ssim_planes(torch.from_numpy(x), torch.from_numpy(y))
    assert planes.shape == (3, 3) and planes.dtype == torch.float32
    assert float(planes.min()) >= 0.0 and float(planes.max()) <= 1.0
    torch.testing.assert_close(
        tk.ssim_loss(torch.from_numpy(x), torch.from_numpy(y)),
        planes.mean(dim=0).sum())
    same = tk.ssim_planes(torch.from_numpy(x), torch.from_numpy(x.copy()))
    assert float(same.abs().max()) == 0.0


def test_ssim_bf16_inputs_use_f32_math():
    x, y = _pair((2, 16, 16, 3), seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    ref = float(jax_ssim(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                         jnp.asarray(yb.float().numpy(), jnp.bfloat16)))
    got = tk.ssim_loss(xb, yb)
    assert got.dtype == torch.float32
    assert abs(float(got) - ref) <= 1e-6
    # the rounded inputs, not f32 ones, are what both saw
    assert abs(float(got) - float(tk.ssim_loss(
        torch.from_numpy(x), torch.from_numpy(y)))) > 1e-6


@pytest.mark.parametrize("kernel", [False, True])
def test_ssim_gradient_matches_jax_grad(kernel):
    """The plain formula's autograd, and the kernel's Function (its backward
    re-runs the plain formula)."""
    x, y = _pair((2, 12, 12, 3), seed=5)
    gx_ref, gy_ref = jax.grad(
        lambda a, b: jax_ssim(a, b, use_pallas=False), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    (3.0 * (tk.ssim_loss if kernel else ssim_loss)(xt, yt)).backward()
    np.testing.assert_allclose(xt.grad.numpy() / 3.0, np.asarray(gx_ref),
                               atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy() / 3.0, np.asarray(gy_ref),
                               atol=1e-5)


def test_ssim_rejects_bad_arguments():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="one shape"):
        tk.ssim_planes(x, torch.zeros(1, 8, 7, 3))
    with pytest.raises(ValueError, match="dtype"):
        tk.ssim_planes(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match=">= 3"):
        tk.ssim_planes(torch.zeros(1, 2, 8, 3), torch.zeros(1, 2, 8, 3))
    with pytest.raises(ValueError, match="NHWC"):
        tk.ssim_planes(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3))


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    x, y = _pair((1, 8, 8, 3), seed=6)
    tk.ssim_loss(torch.from_numpy(x), torch.from_numpy(y))
    assert kernels.launch_counts()["ssim_loss"] == 0
    assert set(kernels.launch_counts()) == {
        "prelu_conv3x3", "fused_lateral", "ssim_loss", "instance_norm_fwd",
        "instance_norm_fwd_only", "instance_norm_bwd"}
