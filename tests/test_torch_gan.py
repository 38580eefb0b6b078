"""The port's adversarial path (``losses/gan.py``, ``train/gan.py``) on the
CPU in f32 against the JAX package.

One G/D step of a narrow ResnetGenerator (ngf 8, 2 blocks) and PatchGAN
(ndf 8) at 32 px, batch 2, with the committed ``hned_synth`` and
``vgg_synth`` snapshots, flax-initialized weights carried across through
``params_from_flax``, ``flip_mode="none"`` and the JAX side jitted (eager,
its first step compiled every primitive and took 86 s). Loss terms at rtol
1e-3, gradients at 2e-3 of each tensor's
largest value, parameters after one Adam step at atol 1e-4. The JAX step
hands out no gradients, so they are read off an SGD step on both sides:
``(before - after) / lr``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (HNED_NPZ, HW, VGG_NPZ, _packed_batch,
                              assert_grads_close, assert_params_close,
                              flat_tree, live_and_dead)
from video_layout_generation_tpu.io import weights as jweights
from video_layout_generation_tpu.losses import gan as jgan_loss
from video_layout_generation_tpu.losses.combined import \
    CombinedLoss as JaxCombinedLoss
from video_layout_generation_tpu.models import discriminators as jdisc
from video_layout_generation_tpu.models import hned as jhned
from video_layout_generation_tpu.models import resnet_gen as jres
from video_layout_generation_tpu.train import gan as jgan
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu_torch.io.weights import (load_hned_params,
                                                          params_from_flax)
from video_layout_generation_tpu_torch.losses import (CombinedLoss, gan_loss,
                                                      gradient_penalty)
from video_layout_generation_tpu_torch.models import (HNED,
                                                      NLayerDiscriminator,
                                                      ResnetGenerator)
from video_layout_generation_tpu_torch.train import gan as tgan
from video_layout_generation_tpu_torch.train import state as tstate

GAN_TERMS = ("loss", "loss_gan", "loss_l1", "loss_style", "loss_seg",
             "loss_d", "loss_d_fake", "loss_d_real")
GEN_KW = dict(input_nc=10, ngf=8, n_blocks=2, norm="instance")
SGD_LR = 1e-2


@pytest.fixture(scope="module")
def frozen():
    thned = HNED()
    thned.load_state_dict(load_hned_params(HNED_NPZ), strict=True)
    return dict(jhned=jhned.HNED(),
                jhned_params=jweights.load_hned_params(HNED_NPZ),
                jcombined=JaxCombinedLoss.create(VGG_NPZ), thned=thned,
                tcombined=CombinedLoss.create(VGG_NPZ, device="cpu"))


@functools.lru_cache(maxsize=None)
def _init_vars(norm_d):
    """The flax initial variables of the generator and the critic, made
    once for every run with this critic norm."""
    jgen = jres.ResnetGenerator(**GEN_KW)
    jd = jdisc.NLayerDiscriminator(9, 8, n_layers=3, norm=norm_d)
    return (jax.jit(jgen.init)(jax.random.key(0),
                               jnp.zeros((1,) + HW + (10,), jnp.float32)),
            jax.jit(jd.init)(jax.random.key(1),
                             jnp.zeros((1,) + HW + (9,), jnp.float32)))


def run_pair(frozen, gan_mode, norm_d, optimizer, lr):
    """One G/D step on both sides from the same weights and batch."""
    packed = _packed_batch(2, seed=11)
    jgen = jres.ResnetGenerator(**GEN_KW)
    jd = jdisc.NLayerDiscriminator(9, 8, n_layers=3, norm=norm_d)
    bn = norm_d == "batch"
    g_vars, d_vars = _init_vars(norm_d)
    d_vars = dict(d_vars)
    stats = d_vars.pop("batch_stats", None)
    state = jgan.GanTrainState(
        gen=jstate.TrainState.create(
            g_vars, jstate.make_optimizer(optimizer, lr)),
        disc=jstate.TrainState.create(
            d_vars, jstate.make_optimizer(optimizer, lr)),
        disc_stats=stats)
    jstep = jgan.make_gan_train_step(
        jgen.apply, jd.apply, frozen["jhned"].apply,
        frozen["jcombined"], gan_mode, flip_mode="none", donate=False,
        disc_batch_stats=bn)
    new, jmetrics = jstep(state, frozen["jhned_params"],
                          {"packed6": jnp.asarray(packed)},
                          jax.random.key(2))

    tgen = ResnetGenerator(**GEN_KW)
    tgen.load_state_dict(params_from_flax(g_vars), strict=True)
    td = NLayerDiscriminator(9, 8, n_layers=3, norm=norm_d)
    td.load_state_dict(params_from_flax(
        dict(d_vars, **({"batch_stats": stats} if bn else {}))), strict=True)
    tstep = tgan.make_gan_train_step(
        tgen, td, frozen["thned"], frozen["tcombined"], gan_mode,
        flip_mode="none", disc_batch_stats=bn, device="cpu")
    tst = tgan.GanTrainState(
        gen=tstate.TrainState.create(tgen,
                                     tstate.make_optimizer(optimizer, lr)),
        disc=tstate.TrainState.create(td,
                                      tstate.make_optimizer(optimizer, lr)))
    tst, tmetrics = tstep(tst, {"packed6": packed})
    out = dict(jmetrics=jmetrics, tmetrics=tmetrics, state=tst)
    for net, before, after, port in (("gen", g_vars, new.gen.params, tst.gen),
                                     ("disc", d_vars, new.disc.params,
                                      tst.disc)):
        out[net] = dict(
            p0=flat_tree(before), jp=flat_tree(after),
            tp={k: v.detach().numpy() for k, v in port.params.items()})
    out["jstats"] = None if stats is None else flat_tree(new.disc_stats)
    return out


def sgd_grads(net):
    return ({k: (net["p0"][k] - net["jp"][k]) / SGD_LR for k in net["p0"]},
            {k: (net["p0"][k] - net["tp"][k]) / SGD_LR for k in net["p0"]})


@pytest.fixture(scope="module")
def lsgan_sgd(frozen):
    return run_pair(frozen, "lsgan", "instance", "sgd", SGD_LR)


def assert_terms_close(pair):
    for k in GAN_TERMS:
        np.testing.assert_allclose(float(pair["tmetrics"][k]),
                                   float(pair["jmetrics"][k]), rtol=1e-3,
                                   atol=1e-6)
    m = pair["tmetrics"]
    assert float(m["loss"]) == pytest.approx(float(
        m["loss_gan"] + m["loss_l1"] + m["loss_style"] + m["loss_seg"]),
        rel=1e-6)
    assert pair["state"].step == 1 and pair["state"].disc.step == 1


def test_lsgan_step_losses_and_gradients_of_both_nets_match_jax(lsgan_sgd):
    assert_terms_close(lsgan_sgd)
    for net, n_dead in (("gen", 9), ("disc", 3)):
        want, got = sgd_grads(lsgan_sgd[net])
        live = assert_grads_close(got, want)
        assert len(live) == len(want) - n_dead, net


@pytest.mark.parametrize("gan_mode", ["lsgan", "vanilla"])
def test_gan_step_parameters_after_adam_match_jax(frozen, lsgan_sgd,
                                                  gan_mode):
    pair = run_pair(frozen, gan_mode, "instance", "adam", 2e-4)
    assert_terms_close(pair)
    for net in ("gen", "disc"):
        grads, _ = sgd_grads(lsgan_sgd[net])     # which tensors are live
        live, _ = live_and_dead(grads)
        if gan_mode == "lsgan":
            assert_params_close(pair[net]["tp"], pair[net]["jp"], grads,
                                live, lr=2e-4)
        else:       # other gradients: every element held at 2 * lr
            for k in live:
                assert np.abs(pair[net]["tp"][k] - pair[net]["jp"][k]
                              ).max() <= 2 * 2e-4 + 1e-4
                assert np.abs(pair[net]["tp"][k] - pair[net]["jp"][k]
                              ).mean() <= 1e-5
        moved = [k for k in live
                 if np.abs(pair[net]["tp"][k] - pair[net]["p0"][k]).max()
                 > 1e-5]
        assert len(moved) == len(live)
    assert pair["state"].disc_stats is None


def test_batchnorm_discriminator_step_and_running_stats_match_jax(frozen):
    pair = run_pair(frozen, "lsgan", "batch", "sgd", SGD_LR)
    assert_terms_close(pair)
    stats = pair["state"].disc_stats
    assert set(stats) == set(pair["jstats"]) and len(stats) == 6
    for k, v in pair["jstats"].items():
        # three forwards in train mode moved them: fake, real, G-side
        np.testing.assert_allclose(stats[k].numpy(), v, atol=1e-5)
        assert np.abs(v - (1.0 if k.endswith("var") else 0.0)).max() > 1e-4
    want, got = sgd_grads(pair["disc"])
    assert_grads_close(got, want)


@pytest.mark.parametrize("gan_mode", ["lsgan", "vanilla", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(gan_mode, real):
    pred = np.random.default_rng(5).standard_normal((2, 3, 3, 1)).astype(
        np.float32) * 3
    ref = float(jgan_loss.gan_loss(jnp.asarray(pred), real, gan_mode))
    got = float(gan_loss(torch.from_numpy(pred), real, gan_mode))
    assert got == pytest.approx(ref, rel=1e-5, abs=1e-6)
    with pytest.raises(NotImplementedError, match="gan mode"):
        gan_loss(torch.from_numpy(pred), real, "hinge")


@pytest.mark.parametrize("interp_type", ["real", "fake"])
def test_gradient_penalty_matches_jax(interp_type):
    rng = np.random.default_rng(6)
    real = rng.standard_normal((2, 32, 32, 9)).astype(np.float32)
    fake = rng.standard_normal((2, 32, 32, 9)).astype(np.float32)
    jd = jdisc.NLayerDiscriminator(9, 8, n_layers=3, norm="instance")
    variables = jax.jit(jd.init)(jax.random.key(3), jnp.asarray(real))

    def penalty(v):
        return jgan_loss.gradient_penalty(
            lambda z: jd.apply(v, z), jnp.asarray(real), jnp.asarray(fake),
            jax.random.key(4), interp_type=interp_type)

    # the penalty, its input gradients and its gradient with respect to
    # the critic's parameters, in one jitted program
    (pen_r, grads_r), dpen_r = jax.jit(lambda v: (
        penalty(v), jax.grad(lambda w: penalty(w)[0])(v)))(variables)
    td = NLayerDiscriminator(9, 8, n_layers=3, norm="instance")
    td.load_state_dict(params_from_flax(variables), strict=True)
    pen, grads = gradient_penalty(td, torch.from_numpy(real),
                                  torch.from_numpy(fake),
                                  interp_type=interp_type)
    assert float(pen.detach()) == pytest.approx(float(pen_r), rel=1e-3)
    np.testing.assert_allclose(grads.detach().numpy(), np.asarray(grads_r),
                               atol=1e-5)
    params = dict(td.named_parameters())
    # the last conv's bias does not reach the input gradient: unused
    dpen = torch.autograd.grad(pen, list(params.values()), allow_unused=True)
    assert dpen[list(params).index("Conv_4.bias")] is None
    assert_grads_close(
        {k: (torch.zeros_like(params[k]) if g is None else g).numpy()
         for k, g in zip(params, dpen)}, flat_tree(dpen_r), tol=5e-3)


def test_gradient_penalty_options():
    d = NLayerDiscriminator(9, 4, n_layers=3)
    real, fake = torch.randn(2, 24, 24, 9), torch.randn(2, 24, 24, 9)
    pen, grads = gradient_penalty(d, real, fake, lambda_gp=0.0)
    assert float(pen) == 0.0 and grads is None
    a = gradient_penalty(d, real, fake, torch.Generator().manual_seed(0))[0]
    b = gradient_penalty(d, real, fake, torch.Generator().manual_seed(0))[0]
    c = gradient_penalty(d, real, fake, torch.Generator().manual_seed(1))[0]
    assert float(a) == float(b) != float(c) and float(a) > 0
    with pytest.raises(NotImplementedError, match="not implemented"):
        gradient_penalty(d, real, fake, interp_type="nearest")


@pytest.mark.parametrize("norm_d", ["instance", "batch"])
def test_wgangp_step_runs_with_a_finite_penalty(frozen, norm_d):
    gen = ResnetGenerator(**GEN_KW)
    disc = NLayerDiscriminator(9, 8, n_layers=3, norm=norm_d)
    step = tgan.make_gan_train_step(
        gen, disc, frozen["thned"], frozen["tcombined"], "wgangp",
        flip_mode="batch", disc_batch_stats=norm_d == "batch", device="cpu",
        generator=torch.Generator().manual_seed(0),
        gp_generator=torch.Generator().manual_seed(1))
    state = tgan.GanTrainState(
        gen=tstate.TrainState.create(gen, tstate.make_optimizer()),
        disc=tstate.TrainState.create(disc, tstate.make_optimizer()))
    before = {k: v.detach().clone() for k, v in state.disc.params.items()}
    state, m = step(state, {"packed6": _packed_batch(2, seed=12)})
    assert all(np.isfinite(float(v)) for v in m.values())
    pen = float(m["loss_d"]) - 0.5 * float(m["loss_d_fake"]
                                           + m["loss_d_real"])
    assert pen > 0
    assert any(not torch.equal(v, before[k])
               for k, v in state.disc.params.items())
    if norm_d == "batch":
        # fake, real and G-side forwards moved the running statistics; the
        # penalty's interpolate forward did not: three lerps of 0.1
        mean = state.disc_stats["BatchNorm_0.mean"]
        assert float(mean.abs().max()) > 0
