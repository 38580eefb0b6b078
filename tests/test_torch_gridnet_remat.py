"""GridNet's ``remat`` in the port (each grid column through
``torch.utils.checkpoint``, the JAX package's ``nn.remat``), on the CPU in
f32: the gradients of a fixed linear function of both heads of a
10-channel GridNet at filters (4, 6, 8) equal the port's without remat bit
for bit, and the JAX package's ``GridNet(remat=True)`` gradients (jitted)
within 2e-3 of each tensor's largest value, a PReLU slope's within 2e-3
relative (measured: 2.9e-6, the slopes 2.1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_multistep import NARROW, gridnet_variables, port_gridnet
from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)
from test_torch_train import HW, flat_tree
from video_layout_generation_tpu.models import gridnet as jgrid

GRAD_TOL = 2e-3


def head_weights(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2,) + HW + (20,)).astype(np.float32),
            rng.standard_normal((2,) + HW + (3,)).astype(np.float32))


@pytest.fixture(scope="module")
def remat_grads():
    """Gradients of sum(seg * a) + sum(img * b) on a 10-channel GridNet:
    the port with and without remat, and the JAX package's with remat."""
    variables = gridnet_variables(10, 43)
    x = np.random.default_rng(44).standard_normal(
        (2,) + HW + (10,)).astype(np.float32)
    a, b = head_weights(45)
    jmodel = jgrid.GridNet(n_channels=10, filters_level=NARROW, remat=True)

    def jloss(v):
        seg, img = jmodel.apply(v, jnp.asarray(x))
        return jnp.sum(seg * a) + jnp.sum(img * b)

    out = {"jax": flat_tree(jax.jit(jax.grad(jloss))(variables))}
    for remat in (True, False):
        net = port_gridnet(variables, 10, remat=remat)
        seg, img = net(torch.from_numpy(x))
        loss = (seg * torch.from_numpy(a)).sum() + (
            img * torch.from_numpy(b)).sum()
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out[remat] = {n: g.numpy() for n, g in zip(names, grads)}
    return out


def test_gridnet_remat_equals_no_remat(remat_grads):
    got, want = remat_grads[True], remat_grads[False]
    assert set(got) == set(want) and len(got) == 182
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_gridnet_remat_matches_jax_remat(remat_grads):
    got, want = remat_grads[True], remat_grads["jax"]
    assert set(got) == set(want)
    for n, w in want.items():
        err = np.abs(got[n] - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, (n, err)


def test_gridnet_remat_only_under_grad():
    """Without autograd (serving, validation) remat changes nothing: the
    columns run directly, with the same outputs."""
    variables = gridnet_variables(8, 46)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (1,) + HW + (8,)).astype(np.float32))
    outs = []
    for remat in (True, False):
        net = port_gridnet(variables, 8, remat=remat)
        with torch.no_grad():
            outs.append(net(x))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
