"""The layout families' train steps of the port (``train/vae_steps.py``) on
the CPU in f32 against the JAX package's jitted steps, one step each.

Both sides start from the JAX net's initial parameters (carried across by
``params_from_flax``) with Adam (lr 1e-3, beta1 0.9) and take numpy layouts
made from a seed; the port gets the JAX step's own random draws
(``jax_cvae_draws``, ``jax_corruption``: the ``fold_in`` calls of the JAX
steps). Tolerances: every metric within 1e-5 relative, every gradient
within 1e-4 of its tensor's largest, the parameters after one Adam step
within 3e-5 where the gradient is at least 1e-4 of its tensor's largest
(Adam moves every element by about lr, so elsewhere within 2 lr + 3e-5; the
ROADMAP's f32 figure). The port against itself: K=1 of each K-step step
equals the single step bit for bit, its noise drawn from the same
generator.
"""

import copy
from typing import Any

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from video_layout_generation_tpu.models import convlstm as jlstm
from video_layout_generation_tpu.models import vae as jvae
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu.train import vae_steps as jsteps
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import convlstm as tlstm
from video_layout_generation_tpu_torch.models import vae as tvae
from video_layout_generation_tpu_torch.train import state as tstate
from video_layout_generation_tpu_torch.train import vae_steps as tsteps

N_CLS, HW, N, LATENT = 8, 16, 2, 8
LAT_SHAPE = (N, 2, 2, LATENT)
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_ATOL = 3e-5
CPU = torch.device("cpu")


@flax.struct.dataclass
class RecordingJaxState(jstate.TrainState):
    grads: Any = None

    def apply_gradients(self, grads):
        return super().apply_gradients(grads).replace(grads=grads)


class RecordingState(tstate.TrainState):
    def apply_gradients(self, grads):
        self.last_grads = {k: g.detach().clone() for k, g in grads.items()}
        return super().apply_gradients(grads)


def states(jmodel, variables, tmodel):
    tmodel.load_state_dict(params_from_flax(variables), strict=True)
    js = RecordingJaxState.create(variables,
                                  jstate.make_optimizer("adam", LR, 0.9))
    base = tstate.TrainState.create(tmodel,
                                    tstate.make_optimizer("adam", LR, 0.9))
    ts = RecordingState(base.params, base.opt_state, base.tx, 0, tmodel)
    return js, ts


def flat(tree):
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def assert_step_matches(js, jmetrics, ts, tmetrics):
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    jgrads, jparams = flat(js.grads), flat(js.params)
    assert set(jgrads) == set(ts.last_grads)
    for k, g in jgrads.items():
        got = ts.last_grads[k].numpy()
        top = np.abs(g).max()
        assert np.abs(got - g).max() <= GRAD_TOL * top, k
        diff = np.abs(ts.params[k].detach().numpy() - jparams[k])
        sure = np.abs(g) >= 1e-4 * top
        assert diff[sure].max() <= PARAM_ATOL, (k, diff[sure].max())
        assert diff.max() <= 2 * LR + PARAM_ATOL, (k, diff.max())


def segs(shape, seed):
    return np.random.default_rng(seed).integers(0, N_CLS, shape).astype(
        np.int32)


def normal(key, shape=LAT_SHAPE):
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, jnp.float32)))


def _vae():
    jm = jvae.LayoutVAE(N_CLS, latent_dim=LATENT)
    v = jm.init(jax.random.key(0), jnp.zeros((1, HW, HW, N_CLS)),
                jax.random.key(1))
    return jm, v, tvae.LayoutVAE(N_CLS, latent_dim=LATENT)


def _cvae():
    jm = jvae.LayoutCVAE(N_CLS, latent_dim=LATENT)
    v = jm.init(jax.random.key(0), jnp.zeros((1, HW, HW, 2 * N_CLS)),
                jnp.zeros((1, HW, HW, N_CLS)), jax.random.key(1))
    return jm, v, tvae.LayoutCVAE(N_CLS, latent_dim=LATENT)


def _convlstm():
    jm = jlstm.ConvLSTMLayoutPredictor(N_CLS, hidden=8, enc_width=8)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 2, HW, HW, N_CLS)))
    return jm, v, tlstm.ConvLSTMLayoutPredictor(N_CLS, 8, 8)


VAE_OPTIONS = {
    "plain": {},
    "free_bits": {"free_bits": 0.02},
    "capacity": {"use_capacity": True},
    "class_weights": {"class_weights": [0.3] + [1.0] * (N_CLS - 1)},
}


@pytest.mark.parametrize("option", sorted(VAE_OPTIONS))
def test_vae_step(option):
    kw = VAE_OPTIONS[option]
    jm, v, tm = _vae()
    js, ts = states(jm, v, tm)
    seg = segs((N, HW, HW), 1)
    key = jax.random.key(7)
    extra = (0.8,) if kw.get("use_capacity") else ()
    js, jmet = jsteps.make_vae_train_step(jm, N_CLS, donate=False, **kw)(
        js, jnp.asarray(seg), key, 0.4, *extra)
    step = tsteps.make_vae_train_step(tm, N_CLS, device="cpu", **kw)
    ts, tmet = step(ts, torch.from_numpy(seg), 0.4, *extra,
                    eps=normal(key))
    assert_step_matches(js, jmet, ts, tmet)


def test_cvae_step():
    jm, v, tm = _cvae()
    js, ts = states(jm, v, tm)
    ctx, tgt = segs((N, 2, HW, HW), 2), segs((N, HW, HW), 3)
    key = jax.random.key(8)
    js, jmet = jsteps.make_cvae_train_step(jm, N_CLS, donate=False)(
        js, jnp.asarray(ctx), jnp.asarray(tgt), key, 0.3)
    ts, tmet = tsteps.make_cvae_train_step(tm, N_CLS, device="cpu")(
        ts, torch.from_numpy(ctx), torch.from_numpy(tgt), 0.3,
        eps=normal(key))
    assert_step_matches(js, jmet, ts, tmet)


def jax_cvae_draws(rng, k, feedback, layout_noise):
    """The draws of the JAX K-step CVAE step with key ``rng``, as
    ``draw_cvae_noise``'s dict."""
    out = {"eps": [], "gen_eps": [], "corrupt": [], "cls": []}
    for i in range(k):
        key = rng if i == 0 else jax.random.fold_in(rng, i)
        out["eps"].append(normal(key))
        if i + 1 == k:
            continue
        if feedback == "prior":
            out["gen_eps"].append(normal(jax.random.fold_in(key, 1 << 16)))
        if layout_noise > 0:
            out["corrupt"].append(jax.random.bernoulli(
                jax.random.fold_in(key, (1 << 16) + 1), layout_noise,
                (N, HW, HW)))
            out["cls"].append(jax.random.randint(
                jax.random.fold_in(key, (1 << 16) + 2), (N, HW, HW), 0,
                N_CLS))
    return {name: (v if name == "eps" else
                   torch.from_numpy(np.stack([np.asarray(x) for x in v])))
            for name, v in out.items() if v}


@pytest.mark.parametrize("feedback,layout_noise",
                         [("prior", 0.0), ("posterior", 0.0),
                          ("prior", 0.3)])
def test_cvae_k3_step(feedback, layout_noise):
    jm, v, tm = _cvae()
    js, ts = states(jm, v, tm)
    window = segs((N, 5, HW, HW), 4)
    rng = jax.random.key(9)
    js, jmet = jsteps.make_cvae_multistep_train_step(
        jm, N_CLS, k=3, donate=False, layout_noise=layout_noise,
        feedback=feedback)(js, jnp.asarray(window), rng, 0.3)
    step = tsteps.make_cvae_multistep_train_step(
        tm, N_CLS, k=3, layout_noise=layout_noise, feedback=feedback,
        device="cpu")
    ts, tmet = step(ts, torch.from_numpy(window), 0.3,
                    noise=jax_cvae_draws(rng, 3, feedback, layout_noise))
    assert_step_matches(js, jmet, ts, tmet)


def test_convlstm_step():
    jm, v, tm = _convlstm()
    js, ts = states(jm, v, tm)
    ctx, tgt = segs((N, 2, HW, HW), 5), segs((N, HW, HW), 6)
    js, jmet = jsteps.make_convlstm_train_step(jm, N_CLS, donate=False)(
        js, jnp.asarray(ctx), jnp.asarray(tgt))
    ts, tmet = tsteps.make_convlstm_train_step(tm, N_CLS, device="cpu")(
        ts, torch.from_numpy(ctx), torch.from_numpy(tgt))
    assert_step_matches(js, jmet, ts, tmet)


def jax_corruption(rng, k, layout_noise):
    keys = [jax.random.fold_in(rng, i) for i in range(k - 1)]
    return {
        "corrupt": torch.from_numpy(np.stack([np.asarray(
            jax.random.bernoulli(jax.random.fold_in(key, 1), layout_noise,
                                 (N, HW, HW))) for key in keys])),
        "cls": torch.from_numpy(np.stack([np.asarray(
            jax.random.randint(jax.random.fold_in(key, 2), (N, HW, HW), 0,
                               N_CLS)) for key in keys]))}


@pytest.mark.parametrize("layout_noise", [0.0, 0.3])
def test_convlstm_k3_step(layout_noise):
    jm, v, tm = _convlstm()
    js, ts = states(jm, v, tm)
    window = segs((N, 5, HW, HW), 7)
    rng = jax.random.key(10)
    js, jmet = jsteps.make_convlstm_multistep_train_step(
        jm, N_CLS, k=3, donate=False, layout_noise=layout_noise)(
            js, jnp.asarray(window), rng)
    step = tsteps.make_convlstm_multistep_train_step(
        tm, N_CLS, k=3, layout_noise=layout_noise, device="cpu")
    noise = jax_corruption(rng, 3, layout_noise) if layout_noise else None
    ts, tmet = step(ts, torch.from_numpy(window), noise=noise)
    assert_step_matches(js, jmet, ts, tmet)


def _port_pair(build):
    """Two copies of one port net with their states."""
    tm = build()
    tm2 = copy.deepcopy(tm)
    opt = tstate.make_optimizer("adam", LR, 0.9)
    return ((tm, tstate.TrainState.create(tm, opt)),
            (tm2, tstate.TrainState.create(tm2, opt)))


def _assert_same(a, b, ma, mb):
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_cvae_k1_bit_identical_to_single_step():
    (tm, st), (tm2, st2) = _port_pair(lambda: tvae.LayoutCVAE(
        N_CLS, LATENT, generator=torch.Generator().manual_seed(0)))
    window = torch.from_numpy(segs((N, 3, HW, HW), 11))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    st, m1 = tsteps.make_cvae_train_step(tm, N_CLS, device="cpu",
                                         generator=g1)(
        st, window[:, :2], window[:, 2], 0.3)
    st2, m2 = tsteps.make_cvae_multistep_train_step(
        tm2, N_CLS, k=1, device="cpu", generator=g2)(st2, window, 0.3)
    _assert_same(st, st2, m1, m2)


def test_convlstm_k1_bit_identical_to_single_step():
    (tm, st), (tm2, st2) = _port_pair(lambda: tlstm.ConvLSTMLayoutPredictor(
        N_CLS, 8, 8, generator=torch.Generator().manual_seed(0)))
    window = torch.from_numpy(segs((N, 3, HW, HW), 12))
    st, m1 = tsteps.make_convlstm_train_step(tm, N_CLS, device="cpu")(
        st, window[:, :2], window[:, 2])
    st2, m2 = tsteps.make_convlstm_multistep_train_step(
        tm2, N_CLS, k=1, layout_noise=0.5, device="cpu")(st2, window)
    _assert_same(st, st2, m1, m2)


@pytest.mark.parametrize("feedback", ["prior", "posterior"])
def test_cvae_k2_reaches_every_parameter(feedback):
    (tm, st), _ = _port_pair(lambda: tvae.LayoutCVAE(
        N_CLS, LATENT, generator=torch.Generator().manual_seed(1)))
    before = {k: p.detach().clone() for k, p in st.params.items()}
    st, m = tsteps.make_cvae_multistep_train_step(
        tm, N_CLS, k=2, feedback=feedback, device="cpu",
        generator=torch.Generator().manual_seed(2))(
            st, torch.from_numpy(segs((N, 4, HW, HW), 13)), 0.3)
    assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(before[k], st.params[k]) for k in before)


def test_unknown_feedback_and_capacity_contract():
    with pytest.raises(ValueError, match="unknown feedback"):
        tsteps.make_cvae_multistep_train_step(
            tvae.LayoutCVAE(N_CLS, LATENT), N_CLS, feedback="teacher",
            device="cpu")
    tm = tvae.LayoutVAE(N_CLS, LATENT)
    st = tstate.TrainState.create(tm, tstate.make_optimizer())
    with pytest.raises(TypeError, match="capacity"):
        tsteps.make_vae_train_step(tm, N_CLS, device="cpu")(
            st, torch.zeros(1, HW, HW, dtype=torch.long), 0.1, 2.0)
