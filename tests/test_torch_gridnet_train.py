"""Training GridNet and CoordGridNet with the port (``train/steps.py``) on
the CPU in f32 against the JAX package.

One step of the port's ``make_train_step`` against the JAX package's
``make_train_step`` over flax ``GridNet.apply``, on the committed
``flagship_096`` snapshot (the 10-channel GridNet at full width) with the
``hned_synth`` and ``vgg_synth`` snapshots, the same numpy batch of 2 at
32x32 on both sides and ``flip_mode="none"``; then a CoordGridNet at
filters (4, 6, 8) with weights made with numpy from a seed
(``test_torch_gridnet_coord.py``, a file of its own so that each stays
well under a minute). The JAX steps are jitted (the eager step takes twice
as long); a state that keeps the gradients it applies hands them out of
the same program.

Tolerances are the port's f32 rules: loss terms rtol 1e-3, every gradient
within 2e-3 of its tensor's largest value (a scalar PReLU slope: relative),
parameters after one Adam step within 1e-4. A PReLU slope's gradient is a
sum over the whole activation with much cancellation, and on the random
narrow nets the JAX package's f32 step is itself up to 1e-2 off its own
float64 step there (f32 reassociation), where the port's f32 step stays
within 2e-3: so the CoordGridNet step is held against the JAX step run in
float64 (``jax.enable_x64``), the flagship step against the f32 one.
"""

from pathlib import Path
from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (HNED_NPZ, HW, TERMS, VGG_NPZ, _packed_batch,
                              assert_grads_close, assert_params_close,
                              flat_tree, recording_state)
from video_layout_generation_tpu.io import weights as jweights
from video_layout_generation_tpu.losses.combined import \
    CombinedLoss as JaxCombinedLoss
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.models import hned as jhned
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu.train import steps as jsteps
from video_layout_generation_tpu_torch.io.weights import (load_hned_params,
                                                          params_from_flax)
from video_layout_generation_tpu_torch.losses import CombinedLoss
from video_layout_generation_tpu_torch.models import (HNED,
                                                      NLayerDiscriminator,
                                                      get_model_cls)
from video_layout_generation_tpu_torch.models import blocks as tblocks
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train import gan as tgan
from video_layout_generation_tpu_torch.train import state as tstate
from video_layout_generation_tpu_torch.train import steps as tsteps

SNAPSHOT = Path(__file__).resolve().parents[1] / "artifacts_store" / \
    "flagship_096.npz"
NARROW = (4, 6, 8)


@flax.struct.dataclass
class RecordingJaxState(jstate.TrainState):
    """The JAX TrainState, also returning the gradients it applied."""
    grads: Any = None

    def apply_gradients(self, grads):
        return super().apply_gradients(grads).replace(grads=grads)


def _unflatten(flat):
    tree = {}
    for key in flat.files:
        if key.startswith("__"):
            continue
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(flat[key])
    return tree


@pytest.fixture(scope="module")
def frozen():
    thned = HNED()
    thned.load_state_dict(load_hned_params(HNED_NPZ), strict=True)
    return dict(jhned=jhned.HNED(),
                jhned_params=jweights.load_hned_params(HNED_NPZ),
                jcombined=JaxCombinedLoss.create(VGG_NPZ), thned=thned,
                tcombined=CombinedLoss.create(VGG_NPZ, device="cpu"))


def numpy_flax_params(net, seed):
    """The flax variables ``{"params": ...}`` of a port net, made with numpy
    from ``seed`` in the shapes of its state dict (which has flax's names):
    lecun-scaled kernels, small biases, PReLU slopes in [0.05, 0.45), drawn
    in the order of the sorted keys: the numbers of
    ``test_torch_gridnet.random_flax_params``, with nothing of JAX traced
    or run to make them."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key, t in sorted(net.state_dict().items()):
        shape = tuple(t.shape)
        *parents, leaf = key.split(".")
        if leaf == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "bias":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.uniform(0.05, 0.45, shape)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v, jnp.float32)
    return {"params": tree}


def port_net(arch, variables, **kw):
    net = get_model_cls(arch)(n_channels=10, **kw)
    net.load_state_dict(params_from_flax(variables), strict=True)
    return net


def to_f64(tree):
    """Every floating leaf of a JAX tree in float64 (under x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def jax_reference(frozen, f64: bool):
    """The JAX side's CombinedLoss, its VGG19 in float64 with ``f64``
    (call it under ``jax.enable_x64(True)``). HNED stays f32 either way:
    it makes the net's input, which no gradient reaches."""
    comb = frozen["jcombined"]
    if not f64:
        return comb
    return JaxCombinedLoss(comb.vgg_model, to_f64(comb.vgg_params))


def run_train_pair(frozen, arch, variables, filters, seed, f64=False):
    """Step 1 of the JAX and the port's train step from the same weights
    and batch: metrics, gradients, parameters before and after Adam. With
    ``f64`` the JAX step runs in float64."""
    packed = _packed_batch(2, seed=seed)
    jmodel = getattr(jgrid, arch)(n_channels=10, filters_level=filters)
    with jax.enable_x64(f64):
        combined = jax_reference(frozen, f64)
        jstep = jsteps.make_train_step(jmodel.apply, frozen["jhned"].apply,
                                       combined, flip_mode="none",
                                       donate=False)
        state0 = RecordingJaxState.create(
            to_f64(variables) if f64 else variables,
            jstate.make_optimizer())
        state1, jmetrics = jstep(state0, frozen["jhned_params"],
                                 {"packed6": jnp.asarray(packed)},
                                 jax.random.key(1))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        jgrads, jparams = flat_tree(state1.grads), flat_tree(state1.params)

    net = port_net(arch, variables, filters_level=filters)
    tstep = tsteps.make_train_step(net, frozen["thned"], frozen["tcombined"],
                                   flip_mode="none", device="cpu")
    tst = recording_state(net, tstate.make_optimizer())
    tst, tmetrics = tstep(tst, {"packed6": packed})
    return dict(
        jmetrics=jmetrics, tmetrics=tmetrics, jgrads=jgrads,
        tgrads={k: v.numpy() for k, v in tst.last_grads.items()},
        jparams=jparams,
        tparams={k: v.detach().numpy() for k, v in tst.params.items()},
        p0=flat_tree(variables), state=tst, net=net, packed=packed)


@pytest.fixture(scope="module")
def flagship_pair(frozen):
    flat = np.load(SNAPSHOT)
    return run_train_pair(frozen, "GridNet", _unflatten(flat), (32, 64, 96),
                          seed=21)


def assert_adam_params_close(got, want, grads, live, lr=2e-4, atol=1e-4):
    """``assert_params_close`` over ``live``, but for the tensors that feed
    a channel whose gradient is zero or nearly (the trained snapshot has a
    dead one): that helper asks 99% of a tensor's gradient to be clear of
    zero, which theirs is not. They are held to its two bounds (``atol``
    where the gradient is clear of zero, ``2 * lr + atol`` elsewhere) with
    90% of the elements clear of zero."""
    feed_dead = {k for k in live if (np.abs(grads[k]) >= 1e-4 * np.abs(
        grads[k]).max()).mean() <= 0.99}
    assert_params_close(got, want, grads, live - feed_dead, lr=lr,
                        atol=atol)
    for k in feed_dead:
        diff = np.abs(got[k] - want[k])
        sure = np.abs(grads[k]) >= 1e-4 * np.abs(grads[k]).max()
        assert diff[sure].max() <= atol, (k, diff[sure].max())
        assert diff.max() <= 2 * lr + atol, (k, diff.max())
        assert sure.mean() > 0.9, k
    return feed_dead


def assert_step_matches(pair):
    for k in TERMS:
        np.testing.assert_allclose(float(pair["tmetrics"][k]),
                                   pair["jmetrics"][k], rtol=1e-3)
    live = assert_grads_close(pair["tgrads"], pair["jgrads"])
    assert live == set(pair["jgrads"]) == set(pair["tgrads"])
    assert_adam_params_close(pair["tparams"], pair["jparams"],
                             pair["jgrads"], live)
    moved = [k for k in live
             if np.abs(pair["tparams"][k] - pair["p0"][k]).max() > 1e-5]
    assert len(moved) == len(live)
    assert pair["state"].step == 1


def test_flagship_train_step_matches_jax(flagship_pair):
    """Loss terms, the gradients of all 182 tensors of the snapshot (its
    185 entries less 3 of metadata; none left out: GridNet has no dead
    bias) and the parameters after Adam."""
    assert len(flagship_pair["jgrads"]) == 182
    assert_step_matches(flagship_pair)
    slopes = [k for k in flagship_pair["jgrads"] if k.endswith(".alpha")]
    assert len(slopes) == 60


def test_rollout_under_inference_mode_then_a_train_step():
    """A rollout (under ``torch.inference_mode``) fills a bf16 module's cast
    cache; a train step on the same module then runs, differentiates the
    live kernel, and the cache follows the parameter's version after
    Adam's in-place update."""
    variables = numpy_flax_params(get_model_cls("GridNet")(
        n_channels=8, filters_level=NARROW), seed=24)
    pred = LayoutPredictor("GridNet", variables, n_frames=2, batch=2,
                           image_hw=HW, filters_level=NARROW, use_bf16=True,
                           device="cpu")
    rng = np.random.default_rng(25)
    img = rng.random((2,) + HW + (3,)).astype(np.float32)
    seg = rng.integers(0, 20, (2,) + HW)
    frames, _ = pred.predict(img, img, seg, seg)
    assert np.isfinite(frames).all()
    net = pred.model
    conv = net.lateral_in.Conv_0
    cached = conv._cast
    assert cached is not None and not cached.is_inference()
    step = tsteps.make_train_step(net, None,
                                  CombinedLoss.create(VGG_NPZ, device="cpu"),
                                  flip_mode="none", device="cpu")
    state = recording_state(net, tstate.make_optimizer())
    packed = _packed_batch(2, seed=26)
    state, m = step(state, {"packed6": np.concatenate(
        [packed[..., :3], packed[..., 6:9], packed[..., 3:6],
         packed[..., 9:]], axis=-1)})
    assert np.isfinite(float(m["loss"]))
    assert all(float(g.abs().max()) > 0 for g in state.last_grads.values())
    with torch.no_grad():
        fresh = conv.weight(torch.bfloat16)
    assert fresh is not cached
    assert torch.equal(fresh, conv.kernel.detach().to(torch.bfloat16))
    with torch.no_grad():
        assert conv.weight(torch.bfloat16) is fresh      # kept again
    with torch.enable_grad():
        live = conv.weight(torch.bfloat16)
    assert live.requires_grad and live.grad_fn is not None


def test_step_factories_check_a_gridnet_for_bf16_on_the_card(monkeypatch):
    """On a CUDA device a GridNet built without ``dtype=torch.bfloat16``
    raises by name in both factories, before anything moves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    net = get_model_cls("CoordGridNet")(n_channels=10, filters_level=NARROW)
    hned = HNED(dtype=torch.bfloat16)
    combined = CombinedLoss.create(VGG_NPZ, device="cpu",
                                   dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="GridNet was built with dtype="):
        tsteps.make_train_step(net, hned, combined)
    with pytest.raises(ValueError, match="GridNet was built with dtype="):
        tgan.make_gan_train_step(net, NLayerDiscriminator(9, 4), hned,
                                 combined)
    assert next(net.parameters()).device.type == "cpu"
    assert isinstance(net.lateral_in.CoordConv_0.Conv_0, tblocks.Conv3x3)



