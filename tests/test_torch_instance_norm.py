"""The port's InstanceNorm (``ops/kernels/instance_norm.py``,
``models/norms.py``) and kernel A's data-gradient Function on the CPU
against the JAX package.

CPU tensors take each kernel's plain version through the same
``torch.autograd.Function`` that launches the CUDA kernels on the card, so
the Function's wiring (saved tensors, the rstd output, the double backward)
is what is tested here; the kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``. The JAX side is the XLA formula
``_xla_instance_norm`` and the Pallas kernels in interpret mode. Tolerances:
1e-5 forward and 1e-4 gradient in f32 (sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.models import norms as jnorms
from video_layout_generation_tpu.ops.pallas import instance_norm as jin
from video_layout_generation_tpu_torch.models import norms as tnorms
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.ops.kernels import conv3x3 as tconv
from video_layout_generation_tpu_torch.ops.kernels import \
    instance_norm as tin


def _rand(*shape, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1.7 + offset).astype(np.float32)


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape,offset", [((2, 8, 8, 5), 0.0),
                                          ((3, 7, 9, 20), 3.0),
                                          ((1, 31, 31, 16), -4.0)])
def test_forward_matches_xla_formula(shape, offset):
    x = _rand(*shape, seed=1, offset=offset)
    ref = np.asarray(jin._xla_instance_norm(jnp.asarray(x), 1e-5))
    got = tin.instance_norm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(tin.instance_norm_plain(
        torch.from_numpy(x)).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas_kernel_interpret(dtype, interpret):
    x = jnp.asarray(_rand(2, 8, 8, 256, seed=2)).astype(dtype)
    assert jin._tileable(x.shape)
    y_ref, (xhat_ref, rstd_ref) = jin._pallas_fwd(x, 1e-5)
    only_ref = jin._pallas_fwd_only(x, 1e-5)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    y, rstd = tin.InstanceNormFunction.apply(xt.requires_grad_(True), 1e-5)
    with torch.no_grad():
        only = tin.instance_norm(xt)
    atol = 1e-5 if dtype == "float32" else 3e-2
    for got, ref in ((y, y_ref), (y, xhat_ref), (only, only_ref)):
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref, np.float32), atol=atol)
    assert rstd.shape == (2, 256) and rstd.dtype == torch.float32
    np.testing.assert_allclose(rstd.detach().numpy(),
                               np.asarray(rstd_ref)[:, 0, 0, :], rtol=1e-5)


def test_gradient_matches_xla_and_pallas_interpret(interpret):
    x = _rand(1, 8, 8, 128, seed=3)
    w = _rand(1, 8, 8, 128, seed=4)

    def loss(fn):
        return lambda z: jnp.sum(fn(z, 1e-5) ** 2 * jnp.asarray(w))

    g_xla = np.asarray(jax.grad(loss(jin._xla_instance_norm))(jnp.asarray(x)))
    g_pal = np.asarray(jax.grad(loss(jin._instance_norm_p))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tin.instance_norm(xt) ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_xla, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), g_pal, atol=1e-4)
    # the backward's plain version alone against the Pallas backward kernel
    y, (xhat, rstd) = jin._pallas_fwd(jnp.asarray(x), 1e-5)
    dx_ref, = jin._pallas_bwd((xhat, rstd), jnp.asarray(w))
    dx = tin.instance_norm_bwd_plain(
        torch.from_numpy(w), torch.from_numpy(np.array(xhat)),
        torch.from_numpy(np.array(rstd)[:, 0, 0, :]))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), atol=1e-5)


def test_gradient_of_a_ragged_shape_matches_autograd_of_the_plain_version():
    x = _rand(3, 5, 7, 6, seed=5, offset=2.0)
    w = torch.from_numpy(_rand(3, 5, 7, 6, seed=6))
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    (tin.instance_norm(a) * w).sum().backward()
    (tin.instance_norm_plain(b) * w).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_double_backward_passes_gradgradcheck_in_f64():
    x = torch.from_numpy(_rand(2, 3, 4, 3, seed=7).astype(np.float64))
    x.requires_grad_(True)

    def fn(z):
        return tin.InstanceNormFunction.apply(z, 1e-5)[0]

    assert torch.autograd.gradcheck(fn, (x,), atol=1e-6)
    assert torch.autograd.gradgradcheck(fn, (x,), atol=1e-6)
    # and the plain version agrees on the second derivative
    assert torch.autograd.gradgradcheck(tin.instance_norm_plain, (x,),
                                        atol=1e-6)


def test_second_derivative_matches_jax():
    """grad of |grad_x sum(IN(x) * w)|^2, the shape of the WGAN-GP term."""
    x, w = _rand(2, 6, 5, 4, seed=8), _rand(2, 6, 5, 4, seed=9)

    def pen_j(z):
        g = jax.grad(lambda u: jnp.sum(
            jin._xla_instance_norm(u, 1e-5) * jnp.asarray(w)))(z)
        return jnp.sum(g ** 2)

    ref = np.asarray(jax.grad(pen_j)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    g, = torch.autograd.grad((tin.instance_norm(xt)
                              * torch.from_numpy(w)).sum(), xt,
                             create_graph=True)
    (g ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, atol=1e-4,
                               rtol=1e-3)


def test_no_grad_and_grad_paths_agree_and_a_constant_plane_is_zero():
    x = torch.from_numpy(_rand(2, 6, 6, 4, seed=10))
    with torch.no_grad():
        a = tin.instance_norm(x)
    b = tin.instance_norm(x.clone().requires_grad_(True))
    assert not a.requires_grad and b.requires_grad
    assert torch.equal(a, b.detach())
    const = torch.full((1, 6, 6, 4), 1.5)
    assert float(tin.instance_norm(const).abs().max()) == 0.0
    # a large mean in bf16 keeps its variance (centered sum of squares)
    big = (x * 0.5 + 100.0).to(torch.bfloat16)
    ref = tin.instance_norm_plain(big.float())
    np.testing.assert_allclose(tin.instance_norm(big).float().numpy(),
                               ref.numpy(), atol=3e-2)


def test_argument_checks_and_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="NHWC"):
        tin.instance_norm(torch.zeros(4, 4, 3))
    x = torch.zeros(1, 4, 4, 3, requires_grad=True)
    tin.instance_norm(x).sum().backward()
    counts = kernels.launch_counts()
    assert counts["instance_norm_fwd"] == counts["instance_norm_bwd"] == 0
    assert counts["instance_norm_fwd_only"] == 0


@pytest.mark.parametrize("norm", ["instance", "batch", "none"])
def test_norm_layers_match_flax(norm):
    x = _rand(3, 6, 5, 4, seed=11, offset=1.0)
    layer = jnorms.get_norm_layer(norm, None, train=True)()
    variables = layer.init(jax.random.key(0), jnp.asarray(x))
    if norm == "batch":
        variables = jax.tree_util.tree_map(
            lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype), variables)
        ref, upd = layer.apply(variables, jnp.asarray(x),
                               mutable=["batch_stats"])
    else:
        ref = layer.apply(variables, jnp.asarray(x))
    mod = tnorms.get_norm_layer(norm)(4)
    if norm == "batch":
        from video_layout_generation_tpu_torch.io.weights import \
            params_from_flax
        mod.load_state_dict(params_from_flax(variables), strict=True)
    got = mod(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    assert tnorms.norm_uses_bias(norm) == jnorms.norm_uses_bias(norm)
    if norm == "batch":
        # running statistics moved as flax moves them; eval uses them
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(mod, k).numpy(),
                np.asarray(upd["batch_stats"][k]), atol=1e-6)
        frozen = mod.mean.clone()
        mod(torch.from_numpy(x), train=True, update_stats=False)
        assert torch.equal(mod.mean, frozen)
        ev_ref = jnorms.get_norm_layer(norm, None, train=False)().apply(
            {"params": variables["params"],
             "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
        np.testing.assert_allclose(
            mod(torch.from_numpy(x), train=False).detach().numpy(),
            np.asarray(ev_ref), atol=1e-5)


def test_unknown_norm_is_refused():
    with pytest.raises(NotImplementedError, match="not found"):
        tnorms.get_norm_layer("layer")


# ---- kernel A's data-gradient Function ------------------------------------

@pytest.mark.parametrize("ci,co,relu_out", [(3, 8, True), (8, 3, False),
                                            (6, 6, True)])
def test_kernel_a_data_gradient_matches_autograd_of_the_plain_version(
        ci, co, relu_out):
    x = _rand(2, 7, 9, ci, seed=12)
    w = torch.from_numpy(_rand(3, 3, ci, co, seed=13) / (3 * ci ** 0.5))
    b = torch.from_numpy(_rand(co, seed=14) * 0.1)
    up = torch.from_numpy(_rand(2, 7, 9, co, seed=15))
    a = torch.from_numpy(x).requires_grad_(True)
    ref = torch.from_numpy(x).requires_grad_(True)
    ya = tconv.prelu_conv3x3(a, w, b, relu_out=relu_out)
    yr = tconv.prelu_conv3x3_plain(ref, w, b, relu_out=relu_out)
    assert torch.equal(ya, yr)
    assert type(ya.grad_fn).__name__ == "_Conv3x3DataGradBackward"
    (ya * up).sum().backward()
    (yr * up).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), ref.grad.numpy(), atol=1e-5)


def test_kernel_a_refuses_the_gradients_it_has_no_kernel_for():
    """No gradient is refused any more: every case that kernel A's data
    gradient does not cover, and any gradient through kernel B, takes the
    Function whose backward is the library's VJP; with autograd off
    everything runs as before."""
    x = torch.zeros(1, 4, 4, 8, requires_grad=True)
    w, b = torch.zeros(3, 3, 8, 8), torch.zeros(8)
    alpha = torch.tensor(0.25)

    def fn(y):
        return type(y.grad_fn).__name__

    assert fn(tconv.prelu_conv3x3(x.detach(), w.clone().requires_grad_(True),
                                  b)) == "_PreluConv3x3Backward"
    assert fn(tconv.prelu_conv3x3(x.detach(), w, b, alpha.requires_grad_(
        True))) == "_PreluConv3x3Backward"
    assert fn(tconv.prelu_conv3x3(x, w, b, stride=2)) \
        == "_PreluConv3x3Backward"
    assert fn(tconv.prelu_conv3x3(x, w, b, torch.tensor(0.25))) \
        == "_PreluConv3x3Backward"
    assert fn(tconv.prelu_conv3x3(x.detach(), w, b, residual=torch.zeros(
        1, 4, 4, 8, requires_grad=True))) == "_PreluConv3x3Backward"
    assert fn(kernels.fused_lateral(x, w, b, alpha.detach(), w, b,
                                    alpha.detach())) == "_FusedLateralBackward"
    assert fn(tconv.prelu_conv3x3(x, w, b)) == "_Conv3x3DataGradBackward"
    # with autograd off everything still runs
    with torch.no_grad():
        assert tconv.prelu_conv3x3(x, w, b, alpha.detach(),
                                   stride=2).shape == (1, 2, 2, 8)
        kernels.fused_lateral(x, w, b, alpha.detach(), w, b, alpha.detach())
