"""Scheduled sampling in the port (``train/scheduled.py``) on the CPU in
f32 against the JAX package's jitted ``make_scheduled_train_step``.

A 10-channel GridNet at filters (4, 6, 8) with weights made with numpy
from a seed, the committed ``hned_synth`` and ``vgg_synth`` snapshots, one
numpy 4-frame window batch of 2 at 32x32. The JAX step is compiled once
(``p`` is traced) and called with p in {0, 1, 0.5}; the port's step is
handed the JAX step's own draws: ``rng_mask, rng_flip = split(rng)``, the
mask ``bernoulli(rng_mask, p, (N, 1, 1, 1))`` and the coin
``bernoulli(rng_flip)``. Tolerances: the loss terms within 1e-5 relative,
the parameters after one Adam step within 3e-5 where the gradient is at
least 1e-4 of its tensor's largest (``assert_adam_close``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_gridnet_train import RecordingJaxState
from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from test_torch_multistep import (LOSS_RTOL, N, NARROW, TERMS,
                                  assert_adam_close, gridnet_variables,
                                  port_gridnet, window)
from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)
from test_torch_train import flat_tree, recording_state
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.train import scheduled as jss
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu_torch.train import scheduled as tss
from video_layout_generation_tpu_torch.train import state as tstate


def jax_mask_and_coin(key: int, p: float):
    rng_mask, rng_flip = jax.random.split(jax.random.key(key))
    mask = np.array(jax.random.bernoulli(rng_mask, p, (N, 1, 1, 1)))
    return mask, bool(jax.random.bernoulli(rng_flip))


def mixed_key(p: float) -> int:
    """A key whose mask at ``p`` picks one example and not the other."""
    return next(k for k in range(1, 200)
                if jax_mask_and_coin(k, p)[0].ravel().tolist() == [True,
                                                                   False])


@pytest.fixture(scope="module")
def pairs(frozen):  # noqa: F811
    variables = gridnet_variables(10, 51)
    packed = window(2, 52)             # 4 frames
    jmodel = jgrid.GridNet(n_channels=10, filters_level=NARROW)
    jstep = jss.make_scheduled_train_step(
        jmodel.apply, frozen["jhned"].apply, frozen["jcombined"],
        donate=False)
    out = {}
    for p, key in ((0.0, 3), (1.0, 4), (0.5, mixed_key(0.5))):
        state1, jm = jstep(
            RecordingJaxState.create(variables, jstate.make_optimizer()),
            frozen["jhned_params"], {"packedseq": jnp.asarray(packed)},
            jax.random.key(key), jnp.float32(p))
        mask, coin = jax_mask_and_coin(key, p)
        net = port_gridnet(variables, 10)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tss, "flip_coin", lambda *a: coin)
            mp.setattr(tss, "draw_sampling_mask",
                       lambda *a: torch.from_numpy(mask))
            tstep = tss.make_scheduled_train_step(
                net, frozen["thned"], frozen["tcombined"], device="cpu")
            tst = recording_state(net, tstate.make_optimizer())
            tst, tm = tstep(tst, {"packedseq": torch.from_numpy(packed)}, p)
        out[p] = dict(
            mask=mask, coin=coin, tm=tm,
            jm={k: np.asarray(v) for k, v in jm.items()},
            jgrads=flat_tree(state1.grads), jparams=flat_tree(state1.params),
            tparams={n: v.detach().numpy() for n, v in tst.params.items()})
    return out


@pytest.mark.parametrize("p", [0.0, 1.0, 0.5])
def test_scheduled_step_matches_jax(pairs, p):
    pair = pairs[p]
    assert pair["mask"].all() == (p == 1.0) and pair["mask"].any() == (p > 0)
    for t in TERMS:
        np.testing.assert_allclose(float(pair["tm"][t]), float(pair["jm"][t]),
                                   rtol=LOSS_RTOL, err_msg=t)
    assert pair["tm"]["ss_p"] == p == float(pair["jm"]["ss_p"])
    assert set(pair["tparams"]) == set(pair["jgrads"])
    assert_adam_close(pair["tparams"], pair["jparams"], pair["jgrads"], 1e-4)


def test_sampling_changes_the_input(pairs):
    """p = 1 feeds every example its own prediction: another loss than
    p = 0's on the same window."""
    assert abs(float(pairs[1.0]["tm"]["loss"])
               - float(pairs[0.0]["tm"]["loss"])) > 1e-3


@pytest.mark.parametrize("ramp", [0, 1, 4])
def test_scheduled_p_equals_jax(ramp):
    for epoch in range(6):
        assert tss.scheduled_p(epoch, 0.5, ramp) == jss.scheduled_p(
            epoch, 0.5, ramp)
    mask = tss.draw_sampling_mask(4096, 0.25,
                                  torch.Generator().manual_seed(0), "cpu")
    assert mask.shape == (4096, 1, 1, 1) and mask.dtype == torch.bool
    assert 0.2 < float(mask.float().mean()) < 0.3


def test_scheduled_sampling_refuses_short_windows(frozen):  # noqa: F811
    loss_fn = tss.make_scheduled_loss_fn(
        port_gridnet(gridnet_variables(10, 53), 10), frozen["thned"],
        frozen["tcombined"])
    imgs = torch.zeros((N, 3, 32, 32, 3))
    with pytest.raises(ValueError, match=">= 4-frame windows"):
        loss_fn(imgs, torch.zeros((N, 3, 32, 32), dtype=torch.long),
                torch.zeros((N, 1, 1, 1), dtype=torch.bool), False)
