"""The port's legacy layout-completion nets (``models/legacy.py``:
``DoubleConv``, ``UNet``, ``EncoderDecoder``, ``Simple``) against the JAX
package's flax modules at 32x32, with the flax variables carried across by
``params_from_flax``.

Tolerances: eval-mode outputs within 1e-5; the running statistics after a
``train=True`` call within 1e-5. The train-mode outputs of the UNet are held
within 1e-4: its 2x2 bottleneck's BatchNorm normalizes over 8 values with
flax's E[x^2] - E[x]^2 variance, which amplifies f32 rounding: the JAX
package's own f32 logits lie about as far from its float64 ones as the
port's do (``test_unet_train_mode_against_float64``), so two f32
implementations cannot agree to 1e-5. The gradient of
``weighted_masked_ce`` is held per tensor within 1e-4 relative in L2."""

import jax
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.losses.ce import (
    weighted_masked_ce as jweighted_masked_ce)
from video_layout_generation_tpu.models import legacy as jlegacy
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.losses.ce import weighted_masked_ce
from video_layout_generation_tpu_torch.models import legacy

N, HW = 2, 32
TOL = 1e-5
TRAIN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(n_classes: int, seed: int = 0):
    """(mask, seg_gt, img) numpy: mask 1 on a cropped box."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((N, HW, HW), np.float32)
    mask[:, 8:20, 4:16] = 1.0
    seg = rng.integers(0, n_classes, (N, HW, HW)).astype(np.int32)
    img = rng.random((N, HW, HW, 3)).astype(np.float32)
    return mask, seg, img


def carry(jmodel, tmodel, args, seed=0):
    """Init the flax module, load its variables into the port's; returns
    the variables."""
    variables = jax.jit(jmodel.init)(jax.random.key(seed), *args)
    tmodel.load_state_dict(params_from_flax(variables), strict=True)
    return variables


def torch_of(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


def run_both(jmodel, tmodel, args, variables):
    """Eval and train outputs of both, and both sides' updated
    statistics."""
    jeval = np.asarray(jax.jit(jmodel.apply)(variables, *args))
    jtrain, jupd = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    with torch.no_grad():
        teval = tmodel(*torch_of(args)).numpy()
        ttrain = tmodel(*torch_of(args), train=True).numpy()
    return jeval, teval, np.asarray(jtrain), ttrain, jupd


def check_stats(tmodel, jupd):
    want = params_from_flax(jupd["batch_stats"])
    got = {k: v for k, v in tmodel.state_dict().items() if k in want}
    assert set(got) == set(want) and want
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=k)


def test_double_conv_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 16, 16, 5)).astype(np.float32)
    tmodel = legacy.DoubleConv(5, 8)
    jmodel = jlegacy.DoubleConv(8)
    variables = carry(jmodel, tmodel, (x,))
    jeval, teval, jtrain, ttrain, jupd = run_both(jmodel, tmodel, (x,),
                                                  variables)
    np.testing.assert_allclose(teval, jeval, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ttrain, jtrain, atol=TOL, rtol=TOL)
    check_stats(tmodel, jupd)


def test_unet_matches_flax():
    mask, seg, img = inputs(5)
    onehot = np.eye(5, dtype=np.float32)[seg]
    tmodel = legacy.UNet(3, 5)
    jmodel = jlegacy.UNet(3, 5)
    args = (img, onehot, 1.0 - mask)
    variables = carry(jmodel, tmodel, args)
    jeval, teval, jtrain, ttrain, jupd = run_both(jmodel, tmodel, args,
                                                  variables)
    assert teval.shape == (N, HW, HW, 5)
    np.testing.assert_allclose(teval, jeval, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ttrain, jtrain, atol=TRAIN_TOL)
    check_stats(tmodel, jupd)


def test_unet_train_mode_against_float64():
    """Both f32 implementations against the JAX package's UNet in float64,
    train mode: each within TRAIN_TOL of it (``pytest -s`` prints how far
    each lies; both lie further than TOL)."""
    mask, seg, img = inputs(5)
    onehot = np.eye(5, dtype=np.float32)[seg]
    tmodel = legacy.UNet(3, 5)
    jmodel = jlegacy.UNet(3, 5)
    args = (img, onehot, 1.0 - mask)
    variables = carry(jmodel, tmodel, args)
    train = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=True, mutable=["batch_stats"])[0])
    jf32 = np.asarray(train(variables, *args))
    with jax.enable_x64(True):
        as64 = lambda t: jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), t)
        jf64 = np.asarray(train(as64(variables), *as64(args)))
    with torch.no_grad():
        tf32 = tmodel(*torch_of(args), train=True).numpy()
    port_err = float(np.abs(tf32 - jf64).max())
    jax_err = float(np.abs(jf32 - jf64).max())
    print(f"train-mode UNet logits, max |f32 - float64|: port {port_err:.3g}"
          f", JAX package {jax_err:.3g}")
    assert jf64.dtype == np.float64
    assert port_err <= TRAIN_TOL and jax_err <= TRAIN_TOL


def test_encoder_decoder_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, HW, HW, 15)).astype(np.float32)
    tmodel = legacy.EncoderDecoder(15, 29)
    jmodel = jlegacy.EncoderDecoder(15, 29)
    variables = carry(jmodel, tmodel, (x,))
    assert sorted(variables["params"]) == [f"Conv_{i}" for i in
                                           sorted(range(17), key=str)]
    jeval, teval, jtrain, ttrain, _ = run_both(jmodel, tmodel, (x,),
                                               variables)
    np.testing.assert_allclose(teval, jeval, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ttrain, jtrain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("model_name", ["u_net", "encoder_decoder"])
def test_simple_matches_flax(model_name):
    """Both modes, eval and train; in u_net mode the embedding exists
    unused on both sides, so strict loading holds."""
    mask, seg, img = inputs(29)
    tmodel = legacy.Simple(29, 15, model_name)
    jmodel = jlegacy.Simple(29, 15, model_name)
    args = (mask, seg, img)
    variables = carry(jmodel, tmodel, args, seed=3)
    assert "embedding" in variables["params"]
    jeval, teval, jtrain, ttrain, jupd = run_both(jmodel, tmodel, args,
                                                  variables)
    np.testing.assert_allclose(teval, jeval, atol=TOL, rtol=TOL)
    tol = TRAIN_TOL if model_name == "u_net" else TOL
    np.testing.assert_allclose(ttrain, jtrain, atol=tol)
    if model_name == "u_net":
        check_stats(tmodel, jupd)
    else:
        assert "batch_stats" not in jupd or not jupd["batch_stats"]


def test_simple29_unet_mask_polarity():
    """tests/test_models_shapes.py's polarity case on the port: outside the
    crop the exact one-hot of the ground truth, inside it the raw
    prediction, equal to flax's."""
    mask = np.zeros((1, HW, HW), np.int32)
    mask[:, 8:16, 8:16] = 1
    seg = np.full((1, HW, HW), 7, np.int32)
    img = np.zeros((1, HW, HW, 3), np.float32)
    tmodel = legacy.simple29_unet(embedding_dim=8)
    jmodel = jlegacy.simple29_unet(embedding_dim=8)
    variables = carry(jmodel, tmodel, (mask, seg, img))
    with torch.no_grad():
        out = tmodel(*torch_of((mask, seg, img))).numpy()
    np.testing.assert_allclose(out[0, 0, 0], np.eye(29)[7], atol=1e-5)
    inside = out[0, 10, 10]
    assert abs(inside[7] - 1.0) > 1e-3 or np.abs(
        np.delete(inside, 7)).max() > 1e-3
    np.testing.assert_allclose(
        out, np.asarray(jax.jit(jmodel.apply)(variables, mask, seg, img)),
        atol=TOL)


def test_simple_encoder_decoder_adds_the_ground_truth():
    """The reference's composite: one-hot inside and outside the crop,
    plus the prediction inside it."""
    mask, seg, _ = inputs(29, seed=4)
    tmodel = legacy.simple29_encoderdecoder(embedding_dim=8)
    with torch.no_grad():
        out = tmodel(*torch_of((mask, seg))).numpy()
        raw = tmodel.layer(tmodel.embedding(torch.where(
            torch.from_numpy(mask).bool(), 29,
            torch.from_numpy(seg).long()))).numpy()
    onehot = np.eye(29, dtype=np.float32)[seg]
    np.testing.assert_allclose(out, raw * mask[..., None] + onehot,
                               atol=1e-6)


def test_weighted_masked_ce_gradient_matches_jax():
    """One gradient of the completion loss through Simple(u_net) in train
    mode, every parameter against ``jax.grad``."""
    mask, seg, img = inputs(29, seed=5)
    tmodel = legacy.Simple(29, 15, "u_net")
    jmodel = jlegacy.Simple(29, 15, "u_net")
    variables = carry(jmodel, tmodel, (mask, seg, img), seed=6)
    weights = legacy.SIMPLE29_CLASS_WEIGHTS

    def jloss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            mask, seg, img, train=True, mutable=["batch_stats"])
        return jweighted_masked_ce(logits, seg, mask, weights)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    want = params_from_flax(jg)
    loss = weighted_masked_ce(tmodel(*torch_of((mask, seg, img)),
                                     train=True),
                              torch.from_numpy(seg), torch.from_numpy(mask),
                              weights)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(grads) == set(want)
    assert grads["embedding.embedding"] is None   # unused in u_net mode
    assert float(want["embedding.embedding"].abs().max()) == 0.0
    # a conv bias that feeds a train-mode BatchNorm cancels against the
    # batch mean: its gradient is 0 in exact arithmetic, rounding noise in
    # f32 on both sides
    scale = max(float(g.norm()) for g in want.values())
    for k, g in grads.items():
        if g is None:
            continue
        if k.startswith("layer.") and ".conv" in k and k.endswith(".bias"):
            assert max(float(g.norm()), float(want[k].norm())) <= (
                1e-4 * scale), k
            continue
        err = float((g - want[k]).norm() / want[k].norm())
        assert err <= 1e-4, (k, err)
