"""The port's GAN step (``train/gan.py``) with a GridNet generator, on the
CPU in f32 against the JAX package's GAN step.

One lsgan G/D step of a narrow GridNet (filters 4, 6, 8) and PatchGAN (ndf
8) at 32x32, batch 2, with the committed ``hned_synth`` and ``vgg_synth``
snapshots, weights made with numpy from a seed and carried across through
``params_from_flax``,
``flip_mode="none"``. The JAX step is jitted, runs in float64 and keeps
the gradients it applies. Loss terms rtol 1e-3, gradients of both nets
within 2e-3 of each tensor's largest value, the generator's parameters
after one Adam step within 1e-4.

A PReLU slope's gradient is a sum over the whole activation with much
cancellation, and here the generator's gradient comes back through the
discriminator too: one slope's (``lateral_in.PReLU_1``) is 5e-3 off the
float64 step in the port's f32 step and 6e-3 in the JAX package's own f32
step, while the other tensors stay within 7e-4. So the generator's 60
slopes are held as one tensor (``slopes_as_one``: each slope's error
against the largest slope gradient), every other tensor by itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_gridnet_train import (NARROW, RecordingJaxState,
                                      assert_adam_params_close,
                                      jax_reference, numpy_flax_params,
                                      port_net, to_f64)
from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from test_torch_train import (TERMS, _packed_batch, assert_grads_close,
                              flat_tree, recording_state)
from video_layout_generation_tpu.models import discriminators as jdisc
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.train import gan as jgan
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import (NLayerDiscriminator,
                                                      get_model_cls)
from video_layout_generation_tpu_torch.ops.kernels import launch_counts
from video_layout_generation_tpu_torch.train import gan as tgan
from video_layout_generation_tpu_torch.train import state as tstate

GAN_TERMS = TERMS + ("loss_gan", "loss_d", "loss_d_fake", "loss_d_real")


def slopes_as_one(grads):
    """The gradients with the scalar PReLU slopes stacked, in sorted order,
    into one vector ``"PReLU slopes"``."""
    slopes = sorted(k for k in grads if k.endswith(".alpha"))
    out = {k: v for k, v in grads.items() if k not in slopes}
    out["PReLU slopes"] = np.array([grads[k] for k in slopes])
    return out


@pytest.fixture(scope="module")
def gan_pair(frozen):  # noqa: F811
    packed = _packed_batch(2, seed=27)
    jmodel = jgrid.GridNet(n_channels=10, filters_level=NARROW)
    g_vars = numpy_flax_params(get_model_cls("GridNet")(
        n_channels=10, filters_level=NARROW), seed=28)
    jd = jdisc.NLayerDiscriminator(9, 8, n_layers=3, norm="instance")
    d_vars = numpy_flax_params(
        NLayerDiscriminator(9, 8, n_layers=3, norm="instance"), seed=29)
    with jax.enable_x64(True):
        combined = jax_reference(frozen, True)
        tx = jstate.make_optimizer()
        state = jgan.GanTrainState(
            gen=RecordingJaxState.create(to_f64(g_vars), tx),
            disc=RecordingJaxState.create(to_f64(d_vars), tx))
        jstep = jgan.make_gan_train_step(
            jmodel.apply, jd.apply, frozen["jhned"].apply, combined, "lsgan",
            flip_mode="none", donate=False)
        new, jmetrics = jstep(state, frozen["jhned_params"],
                              {"packed6": jnp.asarray(packed)},
                              jax.random.key(2))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        jg, jd_grads = flat_tree(new.gen.grads), flat_tree(new.disc.grads)
        jparams = flat_tree(new.gen.params)

    gen = port_net("GridNet", g_vars, filters_level=NARROW)
    disc = NLayerDiscriminator(9, 8, n_layers=3, norm="instance")
    disc.load_state_dict(params_from_flax(d_vars), strict=True)
    tstep = tgan.make_gan_train_step(gen, disc, frozen["thned"],
                                     frozen["tcombined"], "lsgan",
                                     flip_mode="none", device="cpu")
    tst = tgan.GanTrainState(
        gen=recording_state(gen, tstate.make_optimizer()),
        disc=recording_state(disc, tstate.make_optimizer()))
    before = launch_counts()
    tst, tmetrics = tstep(tst, {"packed6": packed})
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, state=tst,
                counted=launch_counts() == before,
                g=(jg, {k: v.numpy() for k, v in tst.gen.last_grads.items()}),
                d=(jd_grads,
                   {k: v.numpy() for k, v in tst.disc.last_grads.items()}),
                gp=(jparams, {k: v.detach().numpy()
                              for k, v in tst.gen.params.items()}))


def test_gridnet_gan_step_matches_jax(gan_pair):
    for k in GAN_TERMS:
        np.testing.assert_allclose(float(gan_pair["tmetrics"][k]),
                                   gan_pair["jmetrics"][k], rtol=1e-3,
                                   atol=1e-6)
    want, got = gan_pair["g"]
    assert len(want) == 182 and len(slopes_as_one(want)) == 182 - 60 + 1
    live = assert_grads_close(slopes_as_one(got), slopes_as_one(want))
    assert live == set(slopes_as_one(want))     # every generator tensor
    assert_adam_params_close(gan_pair["gp"][1], gan_pair["gp"][0], want,
                             set(want))
    want, got = gan_pair["d"]
    # the biases of the three convs an InstanceNorm follows are dead
    assert len(assert_grads_close(got, want)) == len(want) - 3
    assert gan_pair["state"].step == 1 and gan_pair["state"].disc.step == 1
    # on CPU tensors every kernel ran its plain version: nothing counted
    assert gan_pair["counted"]

