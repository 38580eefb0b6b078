"""K-step training of the port (``train/multistep.py``) on the CPU in f32
against the JAX package's ``make_multistep_train_step``.

A GridNet at filters (4, 6, 8) with weights made with numpy from a seed,
the committed ``hned_synth`` and ``vgg_synth`` snapshots, one numpy window
batch of 2 at 32x32. The JAX step is jitted once per configuration and
called with two keys, one whose coin flips the window and one whose coin
does not; the port's step gets that coin and the JAX step's noise draws
(``jax_draws``: the step's own ``fold_in`` / ``split`` calls) in place of
its own draws. Here K=2 with edges; ``test_torch_multistep_k3.py`` holds
K=3 without edges, ``test_torch_multistep_levers.py`` the levers and
GridNet's ``remat`` (files of their own: one JAX compile a file keeps each
under 45 s alone).

Tolerances: loss terms and ``loss_per_step`` within 1e-5 relative, the
parameters after one Adam step within 3e-5 (the ROADMAP's f32 figure;
``assert_adam_close``) wherever the gradient is at least 1e-4 of its
tensor's largest (measured: 7e-7). The port against itself: K=1 equal to
``make_train_step`` bit for bit, and ``remat_steps`` on equal to off bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_gridnet_train import (NARROW, RecordingJaxState,
                                      jax_reference, numpy_flax_params,
                                      to_f64)
from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from test_torch_train import HW, flat_tree, recording_state
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.train import multistep as jms
from video_layout_generation_tpu.train import state as jstate
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import get_model_cls
from video_layout_generation_tpu_torch.train import multistep as tms
from video_layout_generation_tpu_torch.train import state as tstate
from video_layout_generation_tpu_torch.train import steps as tsteps

TERMS = ("loss", "loss_l1", "loss_style", "loss_seg")
LOSS_RTOL = 1e-5
PARAM_ATOL = 3e-5
N = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps at 32x32 gain little from more threads, and the
    suite runs several workers on the machine's cores, whose spinning
    thread pools slowed these files about fivefold: one thread for the
    module (the JAX side keeps its own pool), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window(k: int, seed: int, n: int = N) -> np.ndarray:
    """uint8 ``packedseq`` (n, k+2, H, W, 4): smooth frames that drift from
    one to the next, blocky layouts."""
    rng = np.random.default_rng(seed)
    cells = (n, HW[0] // 4, HW[1] // 4)

    def up(a):
        return a.repeat(4, axis=-3).repeat(4, axis=-2)

    f = up(rng.random(cells + (3,)))
    frames, segs = [], []
    for _ in range(k + 2):
        frames.append((np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))
        segs.append(up(rng.integers(0, 20, cells + (1,))).astype(np.uint8))
        f = f + 0.05 * up(rng.standard_normal(cells + (3,)))
    return np.concatenate([np.stack(frames, 1), np.stack(segs, 1)], -1)


def gridnet_variables(n_channels: int, seed: int):
    return numpy_flax_params(get_model_cls("GridNet")(
        n_channels=n_channels, filters_level=NARROW), seed)


def port_gridnet(variables, n_channels: int, **kw):
    net = get_model_cls("GridNet")(n_channels=n_channels,
                                   filters_level=NARROW, **kw)
    net.load_state_dict(params_from_flax(variables), strict=True)
    return net


def coin_of(key: int, f64: bool = False) -> bool:
    """The JAX step's coin for ``key`` (its uniform draw is float64 under
    ``jax.enable_x64``, so the coin depends on the mode)."""
    with jax.enable_x64(f64):
        return bool(jax.random.bernoulli(jax.random.key(key)))


def jax_draws(key: int, k: int, n: int, feedback_noise: float = 0.0,
              layout_noise: float = 0.0):
    """The perturbations the JAX K-step step draws from ``key``, in the
    port's form (``train/multistep.py:draw_rollout_noise``): step i's
    key is ``split(fold_in(rng, 7), k)[i]``, its feedback noise
    ``normal(key_i)``, its layout mask ``bernoulli(fold_in(key_i, 1))`` and
    classes ``randint(fold_in(key_i, 2))``; the last step's are never
    read. Call it in the step's float mode: under ``jax.enable_x64`` the
    mask's uniform draw is float64 and the classes int64, while the
    frame's noise stays float32, GridNet's output dtype."""
    if feedback_noise <= 0.0 and layout_noise <= 0.0:
        return None
    keys = jax.random.split(jax.random.fold_in(jax.random.key(key), 7), k)
    img = (n,) + HW + (3,)
    seg = (n,) + HW + (1,)
    fb, mask, cls = [], [], []
    for i in range(k - 1):
        fb.append(np.asarray(jax.random.normal(keys[i], img, jnp.float32)))
        mask.append(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(keys[i], 1), layout_noise, seg)))
        cls.append(np.asarray(jax.random.randint(
            jax.random.fold_in(keys[i], 2), seg, 0, 20)).astype(np.float32))
    out = {}
    if feedback_noise > 0.0:
        out["feedback"] = torch.from_numpy(np.stack(fb))
    if layout_noise > 0.0:
        out["layout_mask"] = torch.from_numpy(np.stack(mask))
        out["layout_cls"] = torch.from_numpy(np.stack(cls))
    return out


def key_with_coin(coin: bool, f64: bool = False, start: int = 1) -> int:
    key = start
    while coin_of(key, f64) != coin:
        key += 1
    return key


def jax_step_1(frozen, k, edges, variables, packed, key, f64, levers):
    """Step 1 of the jitted JAX K-step step (float64 with ``f64``): the
    state after it and the metrics."""
    nc = 10 if edges else 8
    jmodel = jgrid.GridNet(n_channels=nc, filters_level=NARROW)
    with jax.enable_x64(f64):
        jstep = jms.make_multistep_train_step(
            jmodel.apply, frozen["jhned"].apply if edges else None,
            jax_reference(frozen, f64), k, flip_mode="batch", donate=False,
            **levers)
        state1, jm = jstep(
            RecordingJaxState.create(to_f64(variables) if f64 else variables,
                                     jstate.make_optimizer()),
            frozen["jhned_params"], {"packedseq": jnp.asarray(packed)},
            jax.random.key(key))
        noise = jax_draws(key, k, N, levers.get("feedback_noise", 0.0),
                          levers.get("layout_noise", 0.0))
        return state1, {m: np.asarray(v) for m, v in jm.items()}, noise


def run_pairs(frozen, k: int, edges: bool, keys, seed: int,
              f64: bool = False, **levers):
    """Step 1 of the jitted JAX K-step step and of the port's, from the
    same weights and window, for each key: the port takes the key's coin
    and noise draws. With ``f64`` the JAX step runs in float64 (on random
    narrow nets its f32 gradients are themselves up to 2e-3 off its
    float64 ones in some tensors, as ``test_torch_gridnet_coord.py``
    found for the one-step step)."""
    nc = 10 if edges else 8
    variables = gridnet_variables(nc, seed)
    packed = window(k, seed + 1)
    out = []
    for key in keys:
        state1, jm, noise = jax_step_1(frozen, k, edges, variables, packed,
                                       key, f64, levers)
        coin = coin_of(key, f64)
        net = port_gridnet(variables, nc)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tms, "flip_coin", lambda *a: coin)
            mp.setattr(tms, "draw_rollout_noise", lambda *a: noise)
            tstep = tms.make_multistep_train_step(
                net, frozen["thned"] if edges else None,
                frozen["tcombined"], k, device="cpu", **levers)
            tst = recording_state(net, tstate.make_optimizer())
            tst, tm = tstep(tst, {"packedseq": torch.from_numpy(packed)})
        out.append(dict(
            coin=coin, jm=jm, tm=tm,
            jgrads=flat_tree(state1.grads), jparams=flat_tree(state1.params),
            tparams={n: v.detach().numpy() for n, v in tst.params.items()},
            tgrads={n: v.numpy() for n, v in tst.last_grads.items()}))
    return out


def assert_adam_close(got, want, grads, sure_at: float, lr=2e-4,
                      atol=PARAM_ATOL):
    """Parameters after one Adam step, which moves an element by about lr
    whatever its gradient's size: every element within ``atol`` where its
    gradient is at least ``sure_at`` of its tensor's largest, every other
    element within 2 * lr + atol (it may move either way on the two
    sides). ``test_torch_train.assert_params_close`` with ``sure_at``
    1e-4."""
    for n, g in grads.items():
        diff = np.abs(got[n] - want[n])
        sure = np.abs(g) >= sure_at * np.abs(g).max()
        assert diff[sure].max() <= atol, (n, diff[sure].max())
        assert diff.max() <= 2 * lr + atol, (n, diff.max())


def assert_pair_matches(pair, k: int, sure_at: float = 1e-4):
    jm, tm = pair["jm"], pair["tm"]
    for t in TERMS:
        np.testing.assert_allclose(float(tm[t]), float(jm[t]),
                                   rtol=LOSS_RTOL, err_msg=t)
    assert tm["loss_per_step"].shape == (k,)
    np.testing.assert_allclose(tm["loss_per_step"].numpy(),
                               jm["loss_per_step"], rtol=LOSS_RTOL)
    # GridNet has no norm layer: every tensor has a gradient (a slope's may
    # be 1e-5 of the largest, not dead)
    assert set(pair["jgrads"]) == set(pair["tgrads"])
    assert all(np.abs(g).max() > 0 for g in pair["jgrads"].values())
    assert_adam_close(pair["tparams"], pair["jparams"], pair["jgrads"],
                      sure_at)


@pytest.fixture(scope="module")
def k2_edges(frozen):  # noqa: F811
    return run_pairs(frozen, 2, True, [key_with_coin(False),
                                       key_with_coin(True)], seed=31)


@pytest.mark.parametrize("flipped", [False, True])
def test_k2_with_edges_matches_jax(k2_edges, flipped):
    pair = k2_edges[int(flipped)]
    assert pair["coin"] == flipped
    assert_pair_matches(pair, 2)


def triplet_of(packed_window: np.ndarray) -> np.ndarray:
    """The ``packed6`` batch of a 3-frame window."""
    p = packed_window
    return np.concatenate([p[:, 0, ..., :3], p[:, 1, ..., :3],
                           p[:, 2, ..., :3], p[:, 0, ..., 3:],
                           p[:, 1, ..., 3:], p[:, 2, ..., 3:]], axis=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_equals_make_train_step_bit_for_bit(frozen, seed):  # noqa: F811
    """K=1 on a 3-frame window is ``make_train_step`` on its triplet: the
    same loss terms and the same parameters after Adam, to the bit, with
    the coin of one seeded generator (seed 0 flips, seed 1 does not)."""
    variables = gridnet_variables(10, 35)
    packed = window(1, 36)
    runs = []
    for kind in ("multistep", "single"):
        net = port_gridnet(variables, 10)
        gen = torch.Generator().manual_seed(seed)
        if kind == "multistep":
            step = tms.make_multistep_train_step(
                net, frozen["thned"], frozen["tcombined"], 1, device="cpu",
                generator=gen)
            batch = {"packedseq": packed}
        else:
            step = tsteps.make_train_step(
                net, frozen["thned"], frozen["tcombined"], device="cpu",
                generator=gen)
            batch = {"packed6": triplet_of(packed)}
        st = tstate.TrainState.create(net, tstate.make_optimizer())
        st, m = step(st, batch)
        runs.append((m, {n: p.detach().clone() for n, p in st.params.items()}))
    (m1, p1), (m2, p2) = runs
    for t in TERMS:
        assert torch.equal(m1[t], m2[t]), t
    assert m1["loss_per_step"].shape == (1,)
    assert torch.equal(m1["loss_per_step"][0], m1["loss"])
    for n in p2:
        assert torch.equal(p1[n], p2[n]), n
    flips = bool(torch.rand((), generator=torch.Generator().manual_seed(
        seed)) < 0.5)
    assert flips == (seed == 0)


def test_remat_steps_on_equals_off(frozen):  # noqa: F811
    """``remat_steps`` recomputes each step in the backward: the loss terms,
    the per-step losses and every gradient equal those without it (K=3,
    no edges: the recomputed region is the same with them)."""
    variables = gridnet_variables(8, 37)
    packed = window(3, 38)
    noise = tms.draw_rollout_noise(3, N, HW, 20, 0.1, 0.1,
                                   torch.Generator().manual_seed(5), "cpu")
    out = []
    for remat in (True, False):
        net = port_gridnet(variables, 8)
        loss_fn = tms.make_multistep_loss_fn(
            net, None, frozen["tcombined"], 3, remat_steps=remat,
            feedback_noise=0.1, layout_noise=0.1)
        imgs, segs = tms.decode_window_batch(
            {"packedseq": torch.from_numpy(packed)})
        total, m = loss_fn(imgs, segs, True, noise)
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad(total, list(net.parameters()))
        out.append((m, dict(zip(names, grads))))
    (m1, g1), (m2, g2) = out
    for t in TERMS + ("loss_per_step",):
        assert torch.equal(m1[t], m2[t]), t
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n


def test_window_helpers():
    packed = window(2, 40)
    b = {"packedseq": torch.from_numpy(packed)}
    assert tms.is_window_batch(b) and not tms.is_window_batch(
        {"packed6": None})
    imgs, segs = tms.decode_window_batch(b)
    assert imgs.shape == (N, 4) + HW + (3,) and imgs.dtype == torch.float32
    assert segs.dtype == torch.int64
    trip = tms.window_to_triplet_batch(b)
    jtrip = jms.window_to_triplet_batch({"packedseq": jnp.asarray(packed)})
    for key in ("img1", "img2", "img3", "seg1", "seg2", "seg3"):
        np.testing.assert_array_equal(trip[key].numpy(),
                                      np.asarray(jtrip[key]))
    with pytest.raises(ValueError, match="needs 4-frame windows"):
        tms.make_multistep_loss_fn(lambda x: x, None, None, 2)(
            imgs[:, :3], segs[:, :3], False)
    with pytest.raises(ValueError, match="flip_mode"):
        tms.make_multistep_train_step(None, None, None, 2,
                                      flip_mode="per_example", device="cpu")
    noise = tms.draw_rollout_noise(3, N, HW, 20, 0.1, 0.5,
                                   torch.Generator().manual_seed(0), "cpu")
    assert noise["feedback"].shape == (2, N) + HW + (3,)
    assert noise["layout_mask"].dtype == torch.bool
    assert 0.3 < float(noise["layout_mask"].float().mean()) < 0.7
    cls = noise["layout_cls"]
    assert cls.dtype == torch.float32 and 0 <= cls.min() and cls.max() < 20
    assert tms.draw_rollout_noise(3, N, HW, 20, 0.0, 0.0, None, "cpu") is None
