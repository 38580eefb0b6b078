"""The gradients of kernel A's and kernel B's autograd Functions
(``ops/kernels/conv3x3.py:_PreluConv3x3``,
``ops/kernels/lateral.py:_FusedLateral``) on CPU tensors in f32, against
two references:

- ``jax.vjp`` of the JAX package's functions on inputs packed with its own
  ``pack2x2`` / ``pack_kernel3x3`` (the Pallas kernels in interpret mode,
  whose ``custom_vjp`` is ``jax.vjp`` of the XLA conv; the stride-2 conv is
  XLA's ``conv_packed_stride2`` in the JAX package too);
- autograd of the plain versions ``prelu_conv3x3_plain`` /
  ``fused_lateral_plain``.

The vjp is taken against the logical NHWC inputs, through the packing, so
that both sides differentiate the same function of the same tensors. Every
gradient within 1e-4 of its tensor's largest value (f32 sums in another
order); a slope's gradient, one sum over the whole activation, within 1e-4
relative.
"""

import functools

import jax
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
from video_layout_generation_tpu_torch.ops.kernels import (
    fused_lateral, fused_lateral_plain, launch_counts, prelu_conv3x3,
    prelu_conv3x3_plain)

N, HW_, CI, CO = 2, 16, 8, 12
TILE_A, TILE_B = 4, 2


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _with_zeros(x):
    """x with every 37th value exactly 0: a PReLU's derivative there is the
    identity's in the kernels and the JAX package (``where(x >= 0, ...)``),
    the slope's in the library's own PReLU backward."""
    x = x.copy()
    x.reshape(-1)[::37] = 0.0
    return x


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax_prelu(x, a):
    return jnp.where(x >= 0, x, a.astype(x.dtype) * x)


def jax_conv_a(stride, with_prelu, with_res):
    """The JAX package's function of kernel A's case, on logical tensors:
    (x, w, b[, alpha][, residual]) -> y."""
    def f(x, w, b, *rest):
        rest = list(rest)
        a = rest.pop(0) if with_prelu else None
        r = rest.pop(0) if with_res else None
        if stride == 2:     # XLA in the JAX package: no Pallas kernel
            xa = _jax_prelu(x, a) if with_prelu else x
            y = conv_packed_stride2(pack2x2(xa), pack_kernel3x3_stride2(w),
                                    b)
            return y if r is None else y + r
        xp, wp = pack2x2(x), pack_kernel3x3(w)
        if with_prelu and with_res:
            y = conv_packed.prelu_conv_packed3x3_res(xp, wp, b, a,
                                                     pack2x2(r), TILE_A)
        elif with_prelu:
            y = conv_packed.prelu_conv_packed3x3(xp, wp, b, a, TILE_A)
        else:
            y = conv_packed.conv_packed3x3_sparse(xp, wp, b, TILE_A)
        y = unpack2x2(y)
        return y + r if (with_res and not with_prelu) else y
    return f


def torch_grads(fn, args, dy, needs):
    """Gradients of ``fn(*args)`` against ``dy`` for the arguments marked
    in ``needs`` (None elsewhere)."""
    leaves = [None if a is None else
              torch.from_numpy(a).requires_grad_(bool(need))
              for a, need in zip(args, needs)]
    y = fn(*leaves)
    wrt = [t for t, need in zip(leaves, needs) if need]
    got = torch.autograd.grad(y, wrt, torch.from_numpy(dy))
    it = iter(got)
    return y, [next(it).numpy() if need else None for need in needs]


def assert_close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.size == 1:
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, (name, err)


A_CASES = [(stride, p, r) for stride in (1, 2) for p in (False, True)
           for r in (False, True)]


def a_inputs(stride, with_prelu, with_res, seed):
    ho = HW_ // stride
    x = _with_zeros(_rand(N, HW_, HW_, CI, seed=seed))
    w = _rand(3, 3, CI, CO, seed=seed + 1, scale=0.2)
    b = _rand(CO, seed=seed + 2, scale=0.1)
    a = np.asarray(0.2, np.float32) if with_prelu else None
    r = _rand(N, ho, ho, CO, seed=seed + 3) if with_res else None
    dy = _rand(N, ho, ho, CO, seed=seed + 4)
    return [x, w, b, a, r], dy


@pytest.mark.parametrize("stride,with_prelu,with_res", A_CASES)
def test_kernel_a_function_gradients_match_jax_and_plain(
        interp, stride, with_prelu, with_res):
    args, dy = a_inputs(stride, with_prelu, with_res, seed=10 * stride)
    needs = [a is not None for a in args]
    before = launch_counts()

    def kernel(x, w, b, a, r):
        return prelu_conv3x3(x, w, b, a, r, stride)

    def plain(x, w, b, a, r):
        return prelu_conv3x3_plain(x, w, b, a, r, stride)

    y, got = torch_grads(kernel, args, dy, needs)
    assert type(y.grad_fn).__name__ == "_PreluConv3x3Backward"
    _, ref = torch_grads(plain, args, dy, needs)
    present = [jnp.asarray(a) for a in args if a is not None]
    _, vjp = jax.vjp(jax_conv_a(stride, with_prelu, with_res), *present)
    jgrads = iter(vjp(jnp.asarray(dy)))
    for name, g, p, need in zip("x w b alpha residual".split(), got, ref,
                                needs):
        if need:
            assert_close(g, next(jgrads), f"{name} vs jax")
            assert_close(g, p, f"{name} vs plain")
    assert launch_counts() == before     # CPU tensors: plain versions


@pytest.mark.parametrize("needs", [
    (False, True, True, True, False),       # parameters only (first conv)
    (True, False, False, False, True),      # activations only
    (False, False, False, True, False),     # the slope alone
])
def test_kernel_a_function_gives_only_the_gradients_asked_for(needs):
    args, dy = a_inputs(2, True, True, seed=40)
    needs = list(needs)

    def kernel(x, w, b, a, r):
        return prelu_conv3x3(x, w, b, a, r, 2)

    def plain(x, w, b, a, r):
        return prelu_conv3x3_plain(x, w, b, a, r, 2)

    y, got = torch_grads(kernel, args, dy, needs)
    assert type(y.grad_fn).__name__ == "_PreluConv3x3Backward"
    _, ref = torch_grads(plain, args, dy, needs)
    for g, p, need in zip(got, ref, needs):
        if need:
            assert_close(g, p, "vs plain")


def test_kernel_a_routes_the_frozen_data_gradient_to_its_own_launch():
    """Only x requiring grad, stride 1, no PReLU, no residual: the data
    gradient is kernel A again (``_Conv3x3DataGrad``); anything more is the
    library's VJP."""
    x = torch.zeros(1, 4, 4, 8, requires_grad=True)
    w, b = torch.zeros(3, 3, 8, 8), torch.zeros(8)
    assert type(prelu_conv3x3(x, w, b, relu_out=True).grad_fn).__name__ \
        == "_Conv3x3DataGradBackward"
    for kw in (dict(alpha=torch.tensor(0.25)), dict(stride=2),
               dict(residual=torch.zeros(1, 4, 4, 8))):
        assert type(prelu_conv3x3(x, w, b, **kw).grad_fn).__name__ \
            == "_PreluConv3x3Backward"
    with torch.no_grad():
        assert prelu_conv3x3(x, w, b).grad_fn is None


def b_inputs(with_res, seed):
    x = _with_zeros(_rand(N, HW_, HW_, CI, seed=seed))
    w0 = _rand(3, 3, CI, CI, seed=seed + 1, scale=0.2)
    w1 = _rand(3, 3, CI, CI, seed=seed + 2, scale=0.2)
    b0 = _rand(CI, seed=seed + 3, scale=0.1)
    b1 = _rand(CI, seed=seed + 4, scale=0.1)
    a0, a1 = np.asarray(0.25, np.float32), np.asarray(0.1, np.float32)
    r = _rand(N, HW_, HW_, CI, seed=seed + 5) if with_res else None
    dy = _rand(N, HW_, HW_, CI, seed=seed + 6)
    return [x, w0, b0, a0, w1, b1, a1, r], dy


def jax_lateral(with_res):
    def f(x, w0, b0, a0, w1, b1, a1, *r):
        y = conv_packed.fused_lateral_packed3x3(
            pack2x2(x), pack_kernel3x3(w0), b0, a0, pack_kernel3x3(w1), b1,
            a1, pack2x2(r[0]) if with_res else None, tile_h=TILE_B)
        return unpack2x2(y)
    return f


@pytest.mark.parametrize("with_res", [False, True])
def test_kernel_b_function_gradients_match_jax_and_plain(interp, with_res):
    args, dy = b_inputs(with_res, seed=50)
    needs = [a is not None for a in args]
    y, got = torch_grads(fused_lateral, args, dy, needs)
    assert type(y.grad_fn).__name__ == "_FusedLateralBackward"
    _, ref = torch_grads(fused_lateral_plain, args, dy, needs)
    present = [jnp.asarray(a) for a in args if a is not None]
    _, vjp = jax.vjp(jax_lateral(with_res), *present)
    jgrads = iter(vjp(jnp.asarray(dy)))
    for name, g, p, need in zip("x w0 b0 a0 w1 b1 a1 residual".split(), got,
                                ref, needs):
        if need:
            assert_close(g, next(jgrads), f"{name} vs jax")
            assert_close(g, p, f"{name} vs plain")


@pytest.mark.parametrize("needs", [
    (False, True, True, True, True, True, True, False),   # parameters only
    (True, False, False, False, False, False, False, True),   # activations
    (False, False, False, False, True, False, True, False),   # conv1 alone
])
def test_kernel_b_function_gives_only_the_gradients_asked_for(needs):
    args, dy = b_inputs(True, seed=60)
    needs = list(needs)
    y, got = torch_grads(fused_lateral, args, dy, needs)
    assert type(y.grad_fn).__name__ == "_FusedLateralBackward"
    _, ref = torch_grads(fused_lateral_plain, args, dy, needs)
    for g, p, need in zip(got, ref, needs):
        if need:
            assert_close(g, p, "vs plain")


def test_kernel_b_backward_in_bf16_agrees_with_the_plain_version():
    """In bf16 the backward runs the library's convs in bf16 and recomputes
    conv0's output rounded to bf16 before PReLU1, as the forward (and
    ``fused_lateral_plain``) rounds it; its slope gradient agrees with
    autograd of the plain version (f32 math) within bf16's precision."""
    args, dy = b_inputs(False, seed=70)
    bf = [torch.from_numpy(a) for a in args[:7]]
    x, w0, b0, a0, w1, b1, a1 = bf
    x, w0, w1 = (t.to(torch.bfloat16) for t in (x, w0, w1))
    a1 = a1.clone().requires_grad_(True)
    y = fused_lateral(x, w0, b0, a0, w1, b1, a1)
    g, = torch.autograd.grad(y, a1, torch.from_numpy(dy).to(y.dtype))
    a1p = a1.detach().clone().requires_grad_(True)
    yp = fused_lateral_plain(x, w0, b0, a0, w1, b1, a1p)
    gp, = torch.autograd.grad(yp, a1p, torch.from_numpy(dy).to(y.dtype))
    assert torch.equal(y, yp)
    np.testing.assert_allclose(float(g), float(gp), rtol=2e-2)
