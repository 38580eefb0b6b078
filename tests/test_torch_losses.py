"""The port's loss stack on the CPU in f32 against the JAX package: pixel
losses, the three cross-entropy variants, the VGG19 feature loss with the
committed ``vgg_synth.npz`` weights, ``CombinedLoss`` with its SSIM term
on both routes, and the ReLU epilogue of kernel A's plain version.

Inputs are made with numpy from a seed and handed to both. Tolerance
rtol 1e-4 (f32 sums in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.losses import ce as jce
from video_layout_generation_tpu.losses import combined as jcombined
from video_layout_generation_tpu.losses import pixel as jpixel
from video_layout_generation_tpu.losses import vgg as jvgg
from video_layout_generation_tpu_torch import losses as tl
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.ops.kernels import (
    prelu_conv3x3, prelu_conv3x3_plain)

STORE = Path(__file__).resolve().parents[1] / "artifacts_store"
VGG_NPZ = str(STORE / "vgg_synth.npz")
RTOL = 1e-4


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["l1_loss", "gradient_loss"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (1, 5, 4, 2)])
def test_pixel_losses_match_jax(name, shape):
    a, b = _rand(*shape, seed=1), _rand(*shape, seed=2)
    ref = getattr(jpixel, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tl, name)(_t(a), _t(b))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_gradient_loss_normalizes_by_input_size():
    a = np.zeros((1, 2, 2, 1), np.float32)
    b = np.array([[[[0.0], [1.0]], [[2.0], [4.0]]]], np.float32)
    # |dH| = 2, 3; |dW| = 1, 2 -> 8 over the 4 input elements
    assert float(tl.gradient_loss(_t(a), _t(b))) == pytest.approx(2.0)


@pytest.mark.parametrize("variant", ["plain", "class_weighted", "masked"])
def test_cross_entropy_variants_match_jax(variant):
    rng = np.random.default_rng(3)
    logits = _rand(2, 6, 5, 7, seed=4) * 3
    labels = rng.integers(0, 7, (2, 6, 5))
    weights = rng.uniform(0.2, 2.0, 7).astype(np.float32)
    mask = (rng.random((2, 6, 5)) < 0.3).astype(np.float32)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    if variant == "plain":
        ref = jce.cross_entropy_loss(jl, jy)
        got = tl.cross_entropy_loss(_t(logits), _t(labels))
    elif variant == "class_weighted":
        ref = jce.class_weighted_ce(jl, jy, jnp.asarray(weights))
        got = tl.class_weighted_ce(_t(logits), _t(labels), _t(weights))
    else:
        ref = jce.weighted_masked_ce(jl, jy, jnp.asarray(mask),
                                     list(weights))
        got = tl.weighted_masked_ce(_t(logits), _t(labels), _t(mask),
                                    list(weights))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_cross_entropy_takes_bf16_logits_and_int32_labels():
    logits = _rand(1, 4, 4, 5, seed=5)
    labels = np.random.default_rng(6).integers(0, 5, (1, 4, 4)).astype(
        np.int32)
    lb = _t(logits).to(torch.bfloat16)
    ref = jce.cross_entropy_loss(jnp.asarray(lb.float().numpy()),
                                 jnp.asarray(labels))
    got = tl.cross_entropy_loss(lb, _t(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    out = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tgt = (out + 0.3 * rng.standard_normal(out.shape)).astype(np.float32)
    return out, tgt


def test_vgg_features_and_loss_match_flax_with_synth_weights(images):
    out, tgt = images
    jmodel, jparams = jvgg.make_vgg_loss(VGG_NPZ)
    tmodel = tl.make_vgg_loss(VGG_NPZ)
    feats_j = jmodel.apply(jparams, jnp.asarray(out))
    feats_t = tmodel(_t(out))
    assert feats_t.shape == (2, 4, 4, 512)
    # features reach about 12 after 12 convs; an element near zero is a
    # difference of large terms, hence the absolute part
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               rtol=RTOL, atol=1e-4)
    ref = jvgg.vgg_feature_loss(jmodel, jparams, jnp.asarray(out),
                                jnp.asarray(tgt))
    got = tl.vgg_feature_loss(tmodel, _t(out), _t(tgt))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_vgg_loader_bridge_and_seeded_init_agree_on_layout():
    from_file = tl.make_vgg_loss(VGG_NPZ).state_dict()
    raw = np.load(VGG_NPZ)
    bridged = tl.make_vgg_loss(params=dict(raw)).state_dict()
    tree = jvgg.load_vgg_params(VGG_NPZ)
    from_tree = tl.make_vgg_loss(params=tree).state_dict()
    assert len(from_file) == 24
    for k, v in from_file.items():
        assert torch.equal(v, bridged[k]) and torch.equal(v, from_tree[k])
        assert torch.equal(v, params_from_flax(tree)[k])
    a, b = tl.make_vgg_loss(seed=3), tl.make_vgg_loss(seed=3)
    c = tl.make_vgg_loss(seed=4)
    assert set(a.state_dict()) == set(from_file)
    assert torch.equal(a.conv3_2.kernel, b.conv3_2.kernel)
    assert not torch.equal(a.conv3_2.kernel, c.conv3_2.kernel)
    assert float(a.conv1_1.bias.abs().max()) == 0.0
    # He-normal: std = sqrt(2 / fan_in)
    k = a.conv4_2.kernel
    assert float(k.std()) == pytest.approx((2.0 / (9 * 512)) ** 0.5, rel=0.02)
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("ssim_kernel", [False, True])
def test_combined_loss_matches_jax(images, ssim_kernel):
    """Differentiated, the SSIM term is the plain formula; under no_grad it
    is the fused kernel's wrapper (its plain version on the CPU), against
    the JAX package's Pallas variant."""
    out, tgt = images
    jloss = jcombined.CombinedLoss.create(VGG_NPZ)
    tloss = tl.CombinedLoss.create(VGG_NPZ, device="cpu")
    if ssim_kernel:
        jloss = jloss.eval_variant()
        assert jloss.ssim_use_pallas
    ref = jloss(jnp.asarray(out), jnp.asarray(tgt))
    o = _t(out).requires_grad_(not ssim_kernel)
    with torch.set_grad_enabled(not ssim_kernel):
        got = tloss(o, _t(tgt))
        with kernels.plain():
            plain = tloss(o, _t(tgt))
    assert got.requires_grad == plain.requires_grad == (not ssim_kernel)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL)
    np.testing.assert_allclose(float(plain.detach()), float(ref), rtol=RTOL)


def test_combined_loss_gradient_matches_jax(images):
    out, tgt = images
    jloss = jcombined.CombinedLoss.create(VGG_NPZ)
    g_ref = jax.grad(lambda o: jloss(o, jnp.asarray(tgt)))(jnp.asarray(out))
    o = _t(out).requires_grad_(True)
    tl.CombinedLoss.create(VGG_NPZ, device="cpu")(o, _t(tgt)).backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_a_plain_relu_epilogue(stride, with_res):
    x = _rand(2, 8, 8, 5, seed=8)
    w = _rand(3, 3, 5, 6, seed=9) * 0.2
    b = _rand(6, seed=10)
    ho = (8 - 1) // stride + 1
    r = _rand(2, ho, ho, 6, seed=11) if with_res else None
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(b)
    if with_res:
        ref = ref + jnp.asarray(r)
    ref = np.asarray(jax.nn.relu(ref))
    rt = None if r is None else _t(r)
    for fn in (prelu_conv3x3, prelu_conv3x3_plain):
        got = fn(_t(x), _t(w), _t(b), None, rt, stride, relu_out=True)
        assert float(got.min()) == 0.0
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=RTOL)
    # off by default: without relu_out the output keeps its sign
    neg = prelu_conv3x3(_t(x), _t(w), _t(b), None, rt, stride)
    assert float(neg.min()) < 0.0
