"""The port's train step with its optimizers, schedules and flip
(``train/state.py``, ``train/schedules.py``, ``train/steps.py``) on the CPU
in f32 against the JAX package and optax.

The step runs a narrow ResnetGenerator (ngf 8, 2 blocks, 32 px, batch 2)
with the committed ``hned_synth`` and ``vgg_synth`` snapshots, flax-initialized
generator weights carried across through ``params_from_flax``, the same
numpy batch on both sides, ``flip_mode="none"`` (the two frameworks' random
numbers differ) and the JAX side jitted. Loss terms are held at rtol
1e-3, gradients at 2e-3 of each tensor's largest value, parameters after
one Adam step at atol 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_layout_generation_tpu.io import weights as jweights
from video_layout_generation_tpu.losses.combined import \
    CombinedLoss as JaxCombinedLoss
from video_layout_generation_tpu.models import hned as jhned
from video_layout_generation_tpu.models import resnet_gen as jres
from video_layout_generation_tpu.train import schedules as jsched
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu.train import steps as jsteps
from video_layout_generation_tpu_torch.io.weights import (load_hned_params,
                                                          params_from_flax)
from video_layout_generation_tpu_torch.losses import CombinedLoss
from video_layout_generation_tpu_torch.models import (HNED, GridNet,
                                                      ResnetGenerator)
from video_layout_generation_tpu_torch.train import schedules as tsched
from video_layout_generation_tpu_torch.train import state as tstate
from video_layout_generation_tpu_torch.train import steps as tsteps

STORE = Path(__file__).resolve().parents[1] / "artifacts_store"
HNED_NPZ = str(STORE / "hned_synth.npz")
VGG_NPZ = str(STORE / "vgg_synth.npz")
HW = (32, 32)
TERMS = ("loss", "loss_l1", "loss_style", "loss_seg")


def _packed_batch(n, seed):
    """uint8 (N, H, W, 12): three smooth-ish frames and three layouts."""
    rng = np.random.default_rng(seed)
    cells = (n, HW[0] // 4, HW[1] // 4)

    def up(a):
        return a.repeat(4, axis=1).repeat(4, axis=2)

    f1 = up(rng.random(cells + (3,)))
    frames = [np.clip(f1 + 0.05 * k * up(rng.standard_normal(cells + (3,))),
                      0, 1) for k in range(3)]
    segs = [up(rng.integers(0, 20, cells))[..., None] for _ in range(3)]
    return np.concatenate([(f * 255 + 0.5).astype(np.uint8) for f in frames]
                          + [s.astype(np.uint8) for s in segs], axis=-1)


def flat_tree(tree):
    """{"a.b.kernel": numpy array} of a flax tree, "params" stripped."""
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def live_and_dead(grads):
    """Names of the tensors with a real gradient, and of the conv biases an
    InstanceNorm follows: their gradient is zero in exact arithmetic and
    rounding noise in f32, on either side."""
    top = max(float(np.abs(g).max()) for g in grads.values())
    dead = {k for k, g in grads.items() if float(np.abs(g).max()) < 1e-5 * top}
    assert all(k.endswith(".bias") for k in dead)
    return set(grads) - dead, dead


def assert_grads_close(got, want, tol=2e-3):
    live, dead = live_and_dead(want)
    assert dead <= live_and_dead(got)[1] | set()
    for k in live:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (k, err)
    return live


def assert_params_close(got, want, grads, live, lr, atol=1e-4):
    """Parameters after one Adam step. Adam's first step moves an element
    by about lr whatever its gradient's size, so an element whose gradient
    is within rounding of zero (under 1e-4 of its tensor's largest) may
    move either way on the two sides: those are held at 2 * lr."""
    assert atol < 2 * lr
    for k in live:
        diff = np.abs(got[k] - want[k])
        sure = np.abs(grads[k]) >= 1e-4 * np.abs(grads[k]).max()
        assert diff[sure].max() <= atol, (k, diff[sure].max())
        assert diff.max() <= 2 * lr + atol, (k, diff.max())
        assert sure.mean() > 0.99


# ---- optimizers and schedules ---------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamax", "sgd"])
def test_three_optimizer_steps_match_optax(name):
    rng = np.random.default_rng(0)
    shapes = {"a.kernel": (3, 3, 4, 5), "a.bias": (5,), "b.alpha": ()}
    p0 = {k: np.asarray(rng.standard_normal(s), np.float32)
          for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.standard_normal(s)
                            * 10.0 ** rng.integers(-4, 1), np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = jstate.make_optimizer(name, lr=2e-3, beta1=0.5)
    jst = jstate.TrainState.create({k: jnp.asarray(v) for k, v in p0.items()},
                                   tx)
    tst = tstate.TrainState.create(
        {k: torch.from_numpy(v.copy()) for k, v in p0.items()},
        tstate.make_optimizer(name, lr=2e-3, beta1=0.5))
    for i, g in enumerate(grads):
        if i == 2:      # the host loop changes the rate between steps
            jst = jstate.set_lr(jst, 5e-4)
            tst = tstate.set_lr(tst, 5e-4)
        jst = jst.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        tst = tst.apply_gradients({k: torch.from_numpy(v)
                                   for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(tst.params[k].numpy(),
                                       np.asarray(jst.params[k]), atol=1e-6)
    assert tst.step == int(jst.step) == 3
    assert tstate.current_lr(tst) == pytest.approx(jstate.current_lr(jst))


def test_adam_keeps_its_first_moment_in_bf16_like_optax():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6, 7)).astype(np.float32)
    jst = jstate.TrainState.create(
        {"w": jnp.asarray(p0)},
        jstate.make_optimizer("adam", moment_dtype=jnp.bfloat16))
    tst = tstate.TrainState.create(
        {"w": torch.from_numpy(p0.copy())},
        tstate.make_optimizer("adam", moment_dtype=torch.bfloat16))
    assert tst.opt_state["mu"]["w"].dtype == torch.bfloat16
    assert tst.opt_state["nu"]["w"].dtype == torch.float32
    for _ in range(3):
        g = rng.standard_normal((6, 7)).astype(np.float32)
        jst = jst.apply_gradients({"w": jnp.asarray(g)})
        tst = tst.apply_gradients({"w": torch.from_numpy(g)})
    np.testing.assert_allclose(tst.params["w"].numpy(),
                               np.asarray(jst.params["w"]), atol=1e-6)
    for other in ("adamax", "sgd"):
        with pytest.raises(ValueError, match="moment_dtype is supported by "
                           "adam only"):
            tstate.make_optimizer(other, moment_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer("rmsprop")


def test_train_state_over_a_module_updates_it_in_place():
    net = ResnetGenerator(10, ngf=4, n_blocks=1)
    state = tstate.TrainState.create(net, tstate.make_optimizer("sgd", 0.5))
    assert set(state.params) == {k for k, _ in net.named_parameters()}
    before = net.Conv_0.kernel.detach().clone()
    state.apply_gradients({k: torch.ones_like(p)
                           for k, p in state.params.items()})
    assert torch.allclose(net.Conv_0.kernel, before - 0.5)
    assert state.step == 1 and state.module is net


@pytest.mark.parametrize("epoch", [0, 3, 50, 99, 100, 150, 250])
def test_schedules_equal_the_jax_package(epoch):
    assert tsched.linear_lr(2e-4, epoch) == jsched.linear_lr(2e-4, epoch)
    assert tsched.linear_lr(2e-4, epoch, 2, 30, 40) == jsched.linear_lr(
        2e-4, epoch, 2, 30, 40)
    assert tsched.step_lr(2e-4, epoch) == jsched.step_lr(2e-4, epoch)
    assert tsched.step_lr(1e-3, epoch, 7, 0.5) == jsched.step_lr(
        1e-3, epoch, 7, 0.5)
    assert tsched.cosine_lr(2e-4, epoch) == jsched.cosine_lr(2e-4, epoch)
    assert tsched.cosine_lr(2e-4, epoch, 60, 1e-6) == jsched.cosine_lr(
        2e-4, epoch, 60, 1e-6)
    assert tstate.epoch_decayed_lr(1e-2, epoch, 5, 0.1) == \
        jstate.epoch_decayed_lr(1e-2, epoch, 5, 0.1)


def test_plateau_schedule_equals_the_jax_package():
    rng = np.random.default_rng(2)
    a, b = tsched.PlateauScheduler(2e-4), jsched.PlateauScheduler(2e-4)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 6), 0.5 + 0.01
                              * rng.random(20)])
    assert [a.update(m) for m in metrics] == [b.update(m) for m in metrics]
    assert a.lr < 2e-4 and a.best == b.best
    for name in ("linear", "step", "cosine", "plateau"):
        assert tsched.get_schedule(name).__name__ == \
            jsched.get_schedule(name).__name__


# ---- the flip ------------------------------------------------------------

@pytest.mark.parametrize("coin", [True, False])
def test_flip_helpers_match_jax_with_the_coin_given(coin):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    s3 = rng.integers(0, 20, (3, 4, 5))
    vec = rng.standard_normal((3,)).astype(np.float32)
    for a in (x, s3, vec):
        np.testing.assert_array_equal(
            tsteps._flip_w(torch.from_numpy(a)).numpy(),
            np.asarray(jsteps._flip_w(jnp.asarray(a))))
    ref = jsteps._maybe_flip(jnp.asarray(coin), jnp.asarray(x),
                             jnp.asarray(s3))
    got = tsteps._maybe_flip(coin, torch.from_numpy(x), torch.from_numpy(s3))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # one coin per example: the JAX step's `sel`
    coins = np.array([True, False, coin])
    got = tsteps._maybe_flip(torch.from_numpy(coins), torch.from_numpy(x),
                             torch.from_numpy(s3))
    for g, a in zip(got, (x, s3)):
        sel = jnp.where(coins.reshape((-1,) + (1,) * (a.ndim - 1)),
                        jsteps._flip_w(jnp.asarray(a)), jnp.asarray(a))
        np.testing.assert_array_equal(g.numpy(), np.asarray(sel))


def test_flip_coin_modes():
    g = torch.Generator().manual_seed(0)
    assert tsteps.flip_coin("none", 4, g, torch.device("cpu")) is None
    coins = [tsteps.flip_coin("batch", 4, g, torch.device("cpu"))
             for _ in range(40)]
    assert set(coins) == {True, False}
    per = tsteps.flip_coin("per_example", 64, g, torch.device("cpu"))
    assert per.shape == (64,) and per.dtype == torch.bool
    assert 0 < int(per.sum()) < 64
    with pytest.raises(ValueError, match="unknown flip_mode"):
        tsteps.flip_coin("both", 4, g, torch.device("cpu"))


# ---- one train step against the JAX package --------------------------------

class RecordingState(tstate.TrainState):
    def apply_gradients(self, grads):
        self.last_grads = {k: g.detach().clone() for k, g in grads.items()}
        return super().apply_gradients(grads)


def recording_state(model, tx):
    base = tstate.TrainState.create(model, tx)
    return RecordingState(base.params, base.opt_state, base.tx, base.step,
                          base.module)


@pytest.fixture(scope="module")
def step_pair():
    """Step 1 on both sides: metrics, gradients, parameters after Adam."""
    packed = _packed_batch(2, seed=4)
    kw = dict(input_nc=10, ngf=8, n_blocks=2, norm="instance")
    jgen = jres.ResnetGenerator(**kw, use_dropout=True)
    hned = jhned.HNED()
    hned_params = jweights.load_hned_params(HNED_NPZ)
    combined = JaxCombinedLoss.create(VGG_NPZ)
    # the JAX side jitted: one program for the step and the gradients
    # (eager, its first step compiled every primitive and took 85 s)
    variables = jax.jit(jgen.init)(jax.random.key(0),
                                   jnp.zeros((1,) + HW + (10,), jnp.float32))
    raw = jsteps.make_train_step(jgen.apply, hned.apply, combined,
                                 flip_mode="none", donate=False, jit=False)
    loss_fn = jsteps.make_loss_fn(jgen.apply, combined)

    @jax.jit
    def step_and_grads(state0, hp, batch, rng):
        state1, metrics = raw(state0, hp, batch, rng)
        dec = jsteps.decode_batch(batch)
        x, f3n = jsteps.prepare_inputs(hned.apply, hp, dec)
        grads = jax.grad(lambda p: loss_fn(p, x, f3n, dec["seg3"])[0])(
            state0.params)
        return state1, metrics, grads

    state0 = jstate.TrainState.create(variables, jstate.make_optimizer())
    state1, jmetrics, jgrads = step_and_grads(
        state0, hned_params, {"packed6": jnp.asarray(packed)},
        jax.random.key(1))
    tgen = ResnetGenerator(**kw, use_dropout=True)
    tgen.load_state_dict(params_from_flax(variables), strict=True)
    thned = HNED()
    thned.load_state_dict(load_hned_params(HNED_NPZ), strict=True)
    tcombined = CombinedLoss.create(VGG_NPZ, device="cpu")
    tstep = tsteps.make_train_step(tgen, thned, tcombined, flip_mode="none",
                                   device="cpu")
    tstate1 = recording_state(tgen, tstate.make_optimizer())
    tstate1, tmetrics = tstep(tstate1, {"packed6": packed})
    return dict(
        jmetrics=jmetrics, tmetrics=tmetrics, jgrads=flat_tree(jgrads),
        tgrads={k: v.numpy() for k, v in tstate1.last_grads.items()},
        jparams=flat_tree(state1.params),
        tparams={k: v.detach().numpy() for k, v in tstate1.params.items()},
        p0=flat_tree(variables), state=tstate1, step=tstep, packed=packed,
        nets=(tgen, thned, tcombined))


def test_train_step_loss_terms_match_jax(step_pair):
    for k in TERMS:
        np.testing.assert_allclose(float(step_pair["tmetrics"][k]),
                                   float(step_pair["jmetrics"][k]),
                                   rtol=1e-3)
    assert not any(v.requires_grad for v in step_pair["tmetrics"].values())


def test_train_step_gradients_match_jax(step_pair):
    live = assert_grads_close(step_pair["tgrads"], step_pair["jgrads"])
    assert {"Conv_0.kernel", "ResnetBlock_1.Conv_1.kernel",
            "ConvTranspose_0.kernel", "last_conv_seg.bias"} <= live
    # the biases before an InstanceNorm are the only tensors left out
    assert len(live) == len(step_pair["jgrads"]) - 9


def test_train_step_parameters_after_adam_match_jax(step_pair):
    s = step_pair
    live, _ = live_and_dead(s["jgrads"])
    assert_params_close(s["tparams"], s["jparams"], s["jgrads"], live,
                        lr=2e-4)
    moved = [k for k in live if np.abs(s["tparams"][k] - s["p0"][k]).max()
             > 1e-5]
    assert len(moved) == len(live)
    assert s["state"].step == 1


def test_train_step_flips_and_keeps_training(step_pair):
    """A second and third step with the flip on: the loss stays finite and
    the flip changes it (the coin is the generator's)."""
    gen, hned, combined = step_pair["nets"]
    batch = {"packed6": step_pair["packed"]}
    state = step_pair["state"]
    seen = set()
    for seed in range(6):
        step = tsteps.make_train_step(
            gen, hned, combined, flip_mode="batch", device="cpu",
            generator=torch.Generator().manual_seed(seed))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        with torch.no_grad():       # same weights for every seed
            for k, v in state.params.items():
                v.copy_(snap[k])
        seen.add(round(float(m["loss"]), 4))
    assert len(seen) == 2       # flipped or not
    per = tsteps.make_train_step(gen, hned, combined,
                                 flip_mode="per_example", device="cpu")
    assert np.isfinite(float(per(state, batch)[1]["loss"]))
    with pytest.raises(ValueError, match="unknown flip_mode"):
        tsteps.make_train_step(gen, hned, combined, flip_mode="vertical",
                               device="cpu")


def test_train_steps_refuse_a_gridnet_and_name_the_missing_kernels(
        step_pair):
    """Both step factories take a GridNet and a CoordGridNet (no longer
    refused: kernels A and B differentiate through the library's VJP), and
    two steps of each move every parameter."""
    from video_layout_generation_tpu_torch.models import (
        NLayerDiscriminator, get_model_cls)
    from video_layout_generation_tpu_torch.train.gan import (
        GanTrainState, make_gan_train_step)
    _, hned, combined = step_pair["nets"]
    batch = {"packed6": step_pair["packed"]}
    for arch in ("GridNet", "CoordGridNet"):
        net = get_model_cls(arch)(n_channels=10, filters_level=(4, 6, 8))
        disc = NLayerDiscriminator(9, 4)
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        step = tsteps.make_train_step(
            net, hned, combined, device="cpu",
            generator=torch.Generator().manual_seed(0))
        state = tstate.TrainState.create(net, tstate.make_optimizer())
        gan = make_gan_train_step(
            net, disc, hned, combined, device="cpu",
            generator=torch.Generator().manual_seed(1))
        gstate = GanTrainState(
            gen=state, disc=tstate.TrainState.create(
                disc, tstate.make_optimizer()))
        state, m = step(state, batch)
        gstate, gm = gan(gstate, batch)
        assert np.isfinite(float(m["loss"])) and np.isfinite(
            float(gm["loss"])) and np.isfinite(float(gm["loss_d"]))
        still = [k for k, p in net.named_parameters()
                 if torch.equal(p.detach(), start[k])]
        assert not still, (arch, still[:3])
        assert state.step == 2 and gstate.disc.step == 1


def test_train_entry_points_default_to_the_card_and_raise_without_one(
        step_pair, monkeypatch):
    from video_layout_generation_tpu_torch.models import NLayerDiscriminator
    from video_layout_generation_tpu_torch.train.gan import \
        make_gan_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen, hned, combined = step_pair["nets"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_train_step(gen, hned, combined)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_gan_train_step(gen, NLayerDiscriminator(9, 4), hned, combined)
    assert next(gen.parameters()).device.type == "cpu"


def test_eval_step_takes_a_resnet_generator_and_names_the_net_it_refuses(
        step_pair):
    from video_layout_generation_tpu_torch.device import require_bf16
    gen, hned, combined = step_pair["nets"]
    out = tsteps.make_eval_step(gen, hned, combined,
                                n_classes=20, device="cpu")(
        {"packed6": step_pair["packed"]})
    assert out[1].shape == (2,) + HW and np.isfinite(float(out[0]["loss"]))
    with pytest.raises(ValueError, match="CoordGridNet|GridNet was built"):
        require_bf16(torch.device("cuda"),
                     {type(GridNet()).__name__: GridNet()})
