"""The variational objectives of the port (``losses/vae.py``) and the KL
schedules of ``train/vae_steps.py`` against the JAX package's, on the CPU
in f32: every KL function and every remedy of ``vae_loss`` (free bits,
capacity, class weights, and capacity over free bits) to 1e-6 relative,
with inputs made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_layout_generation_tpu.losses import vae as jloss
from video_layout_generation_tpu.train import vae_steps as jsteps
from video_layout_generation_tpu_torch.losses import vae as tloss
from video_layout_generation_tpu_torch.train import vae_steps as tsteps

RTOL = 1e-6


def toy(seed=0, n=3, hw=8, c=5, d=4):
    rng = np.random.default_rng(seed)
    return dict(
        logits=rng.normal(size=(n, hw, hw, c)).astype(np.float32),
        ids=rng.integers(0, c, (n, hw, hw)).astype(np.int32),
        mu=rng.normal(size=(n, 2, 2, d)).astype(np.float32),
        lv=(rng.normal(size=(n, 2, 2, d)) * 0.5).astype(np.float32),
        mu_p=rng.normal(size=(n, 2, 2, d)).astype(np.float32),
        lv_p=(rng.normal(size=(n, 2, 2, d)) * 0.5).astype(np.float32))


def both(d, *names):
    return ([jnp.asarray(d[k]) for k in names],
            [torch.from_numpy(d[k]) for k in names])


def close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0)


def test_kl_standard_normal():
    j, p = both(toy(), "mu", "lv")
    close(tloss.kl_standard_normal(*p), jloss.kl_standard_normal(*j))


@pytest.mark.parametrize("free_bits", [0.05, 0.5, 3.0])
def test_kl_free_bits(free_bits):
    j, p = both(toy(1), "mu", "lv")
    for g, w in zip(tloss.kl_standard_normal_free_bits(*p, free_bits),
                    jloss.kl_standard_normal_free_bits(*j, free_bits)):
        close(g, w)


def test_kl_free_bits_clamped_dims_have_no_gradient():
    mu = torch.zeros(2, 2, 2, 3, requires_grad=True)
    used, raw = tloss.kl_standard_normal_free_bits(mu, torch.zeros_like(mu),
                                                   0.5)
    assert float(raw.detach()) == 0.0
    assert float(used.detach()) == pytest.approx(12 * 0.5)
    (g,) = torch.autograd.grad(used, mu)
    assert torch.all(g == 0)


def test_kl_gaussians():
    j, p = both(toy(2), "mu", "lv", "mu_p", "lv_p")
    close(tloss.kl_gaussians(*p), jloss.kl_gaussians(*j))


REMEDIES = {
    "plain": {},
    "free_bits": {"free_bits": 0.3},
    "capacity": {"capacity": 2.5},
    "class_weights": {"class_weights": [0.2, 1.0, 1.5, 1.0, 0.7]},
    "capacity_over_free_bits": {"free_bits": 0.3, "capacity": 7.0},
}


@pytest.mark.parametrize("remedy", sorted(REMEDIES))
def test_vae_loss(remedy):
    kw = REMEDIES[remedy]
    j, p = both(toy(3), "logits", "ids", "mu", "lv")
    jkw = dict(kw)
    if "class_weights" in kw:
        jkw["class_weights"] = jnp.asarray(kw["class_weights"], jnp.float32)
    want_total, want = jloss.vae_loss(*j, beta=0.7, **jkw)
    got_total, got = tloss.vae_loss(*p, beta=0.7, **kw)
    close(got_total, want_total)
    for k in ("loss", "recon", "kl"):
        close(got[k], want[k])


def test_cvae_loss():
    d = toy(4)
    j, p = both(d, "logits", "ids", "mu", "lv", "mu_p", "lv_p")
    want_total, want = jloss.cvae_loss(j[0], j[1], (j[2], j[3]),
                                       (j[4], j[5]), beta=0.3)
    got_total, got = tloss.cvae_loss(p[0], p[1], (p[2], p[3]), (p[4], p[5]),
                                     beta=0.3)
    close(got_total, want_total)
    for k in ("loss", "recon", "kl"):
        close(got[k], want[k])


@pytest.mark.parametrize("step", [0, 1, 7, 250, 499, 500, 1200])
def test_kl_schedules(step):
    for kw in ({"warmup_steps": 500, "beta_max": 0.05},
               {"warmup_steps": 0}, {"cycle_steps": 300, "beta_max": 2.0}):
        assert tsteps.kl_anneal(step, **kw) == jsteps.kl_anneal(step, **kw)
    assert (tsteps.capacity_schedule(step, 25.0, 700)
            == jsteps.capacity_schedule(step, 25.0, 700))
