"""The pix2pix nets of the port (ResnetGenerator, UnetGenerator,
NLayerDiscriminator, PixelDiscriminator) with their layers, initializers,
factories and weight bridge, on the CPU in f32 against the JAX package.

Narrow nets (ngf 4-8, 2 blocks, 32 px, batch 2) with flax-initialized
weights carried across through ``params_from_flax``, the same numpy inputs
on both sides, the JAX side without ``jit``. Outputs are held at atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.models import discriminators as jdisc
from video_layout_generation_tpu.models import init as jinit
from video_layout_generation_tpu.models import resnet_gen as jres
from video_layout_generation_tpu.models import unet_gen as junet
from video_layout_generation_tpu_torch import models as tmodels
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import init as tinit
from video_layout_generation_tpu_torch.models import layers as tlayers
from video_layout_generation_tpu_torch.ops import kernels

NORMS = ["instance", "batch", "none"]
ATOL = 1e-4


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flax_init(module, x, seed=0):
    """flax variables with the running statistics and the BatchNorm affine
    moved off their init values, so that they matter."""
    with jax.disable_jit():
        variables = module.init(jax.random.key(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)

    def nudge(path, a):
        name = path[-1].key
        if name in ("mean", "bias"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if name in ("var", "scale"):
            return a * (1 + 0.2 * rng.random(a.shape).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(nudge, dict(variables))


def _load(port_module, variables):
    state = params_from_flax(variables)
    port_module.load_state_dict(state, strict=True)
    # the bridge repacks nothing: every leaf keeps flax's shape
    flat = jax.tree_util.tree_leaves(variables)
    assert sorted(tuple(a.shape) for a in flat) == sorted(
        tuple(t.shape) for t in state.values())
    return port_module


@pytest.mark.parametrize("norm", NORMS)
def test_resnet_generator_matches_jax(norm):
    x = _x(2, 32, 32, 10, seed=1)
    kw = dict(input_nc=10, ngf=8, n_blocks=2, norm=norm)
    jm = jres.ResnetGenerator(**kw, use_dropout=True)
    variables = _flax_init(jm, x)
    with jax.disable_jit():
        seg_r, img_r = jm.apply(variables, jnp.asarray(x))
    tm = _load(tmodels.ResnetGenerator(**kw, use_dropout=True), variables)
    seg, img = tm(torch.from_numpy(x))
    assert seg.shape == (2, 32, 32, 20) and img.shape == (2, 32, 32, 3)
    assert seg.dtype == img.dtype == torch.float32
    np.testing.assert_allclose(seg.detach().numpy(), np.asarray(seg_r),
                               atol=ATOL)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_r),
                               atol=ATOL)
    # the kernel's plain version gives the same on the CPU
    with kernels.plain():
        seg_p, img_p = tm(torch.from_numpy(x))
    assert torch.equal(seg_p, seg) and torch.equal(img_p, img)


def test_resnet_generator_bf16_and_names():
    tm = tmodels.ResnetGenerator(input_nc=10, ngf=8, n_blocks=2,
                                 dtype=torch.bfloat16)
    seg, img = tm(torch.from_numpy(_x(1, 16, 16, 10)))
    assert seg.dtype == img.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert float(img.abs().max()) <= 1.0
    names = set(tm.state_dict())
    assert {"Conv_0.kernel", "Conv_0.bias", "ResnetBlock_1.Conv_1.kernel",
            "ConvTranspose_1.kernel", "last_conv_img.bias",
            "last_conv_seg.kernel"} <= names
    assert tm.ConvTranspose_0.kernel.shape == (3, 3, 32, 16)   # flax HWIO
    batch = tmodels.ResnetGenerator(input_nc=10, ngf=8, n_blocks=1,
                                    norm="batch")
    assert "BatchNorm_0.mean" in batch.state_dict()
    assert batch.Conv_0.bias is None and batch.last_conv_img.bias is not None


@pytest.mark.parametrize("norm", NORMS)
def test_unet_generator_matches_jax(norm):
    x = _x(2, 32, 32, 10, seed=2)
    kw = dict(input_nc=10, num_downs=5, ngf=4, norm=norm)
    jm = junet.UnetGenerator(**kw, use_dropout=True)
    variables = _flax_init(jm, x)
    with jax.disable_jit():
        ref = jm.apply(variables, jnp.asarray(x))
    tm = _load(tmodels.UnetGenerator(**kw, use_dropout=True), variables)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("kind", ["patch", "pixel"])
def test_discriminators_match_jax(kind, norm):
    x = _x(2, 32, 32, 9, seed=3)
    if kind == "patch":
        jm = jdisc.NLayerDiscriminator(9, 8, n_layers=3, norm=norm)
        tm = tmodels.NLayerDiscriminator(9, 8, n_layers=3, norm=norm)
        out_shape = (2, 2, 2, 1)
    else:
        jm = jdisc.PixelDiscriminator(9, 8, norm=norm)
        tm = tmodels.PixelDiscriminator(9, 8, norm=norm)
        out_shape = (2, 32, 32, 1)
    variables = _flax_init(jm, x)
    _load(tm, variables)
    with jax.disable_jit():
        ref = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == out_shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    if norm == "batch":
        # train mode: batch statistics, and the running ones move as flax's
        with jax.disable_jit():
            ref_t, upd = jm.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        got_t = tm(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(ref_t),
                                   atol=ATOL)
        want = params_from_flax(upd["batch_stats"])
        for k, v in want.items():
            np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(),
                                       atol=1e-5)
        frozen = {k: tm.state_dict()[k].clone() for k in want}
        tm(torch.from_numpy(x), train=True, update_stats=False)
        assert all(torch.equal(tm.state_dict()[k], v)
                   for k, v in frozen.items())


def test_patch_discriminator_refuses_a_small_input():
    d = tmodels.NLayerDiscriminator(9, 4, n_layers=3)
    with pytest.raises(ValueError, match="needs input >= 24px"):
        d(torch.zeros(1, 16, 16, 9))
    assert d(torch.zeros(1, 24, 24, 9)).shape == (1, 1, 1, 1)


@pytest.mark.parametrize("k,padding,out_pad,flax_pad",
                         [(3, 1, 1, ((1, 2), (1, 2))), (4, 1, 0, "SAME")])
def test_conv_transpose_keeps_the_flax_kernel_and_matches_flax(
        k, padding, out_pad, flax_pad):
    import flax.linen as nn
    x = _x(2, 6, 5, 4, seed=4)
    jm = nn.ConvTranspose(7, (k, k), strides=(2, 2), padding=flax_pad)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x))
    tm = tlayers.ConvTranspose(4, 7, k, padding=padding,
                               output_padding=out_pad)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 12, 10, 7) and got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    # the gradient arrives in flax's layout too
    w = torch.from_numpy(_x(2, 12, 10, 7, seed=5))
    (got * w).sum().backward()
    g_ref = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x))
                                       * jnp.asarray(w.numpy())))(variables)
    np.testing.assert_allclose(tm.kernel.grad.numpy(),
                               np.asarray(g_ref["params"]["kernel"]),
                               atol=1e-4)


@pytest.mark.parametrize("mode,jax_mode", [("reflect", "reflect"),
                                           ("replicate", "edge"),
                                           ("zero", "constant")])
def test_pad2_matches_jnp_pad(mode, jax_mode):
    x = _x(2, 5, 6, 3, seed=6)
    ref = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode=jax_mode)
    got = tlayers.pad2(torch.from_numpy(x), 3, mode)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jres._pad2(jnp.asarray(x), 3, mode)), ref)
    with pytest.raises(NotImplementedError, match="padding"):
        tlayers.pad2(torch.from_numpy(x), 1, "circular")


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming",
                                       "orthogonal"])
def test_initializers_have_the_jax_package_scales(init_type):
    shape = (3, 3, 32, 48)
    ref = np.asarray(jinit.get_initializer(init_type, 0.02)(
        jax.random.key(0), shape, jnp.float32))
    g = torch.Generator().manual_seed(0)
    got = tinit.get_initializer(init_type, 0.02)(shape, g)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(float(got.std()), float(ref.std()), rtol=0.05)
    assert abs(float(got.mean())) < 0.1 * float(got.std())
    again = tinit.get_initializer(init_type, 0.02)(
        shape, torch.Generator().manual_seed(0))
    assert torch.equal(got, again)          # the generator decides
    if init_type == "orthogonal":
        for m in (got.reshape(-1, 48).numpy(), ref.reshape(-1, 48)):
            np.testing.assert_allclose(m.T @ m, 0.02 ** 2 * np.eye(48),
                                       atol=1e-8)


def test_unknown_initializer_is_refused():
    with pytest.raises(NotImplementedError, match="initialization method"):
        tinit.get_initializer("uniform")


def test_generator_seeds_the_initial_weights():
    def make(seed):
        return tmodels.ResnetGenerator(
            10, ngf=4, n_blocks=1, init_type="xavier",
            generator=torch.Generator().manual_seed(seed))

    a, b, c = make(1), make(1), make(2)
    assert torch.equal(a.Conv_0.kernel, b.Conv_0.kernel)
    assert not torch.equal(a.Conv_0.kernel, c.Conv_0.kernel)
    assert float(a.Conv_0.bias.abs().max()) == 0.0


def test_factories_and_registry():
    g = tmodels.define_G(10, 3, 4, "resnet_6blocks", norm="instance")
    assert isinstance(g, tmodels.ResnetGenerator) and g.n_blocks == 6
    assert tmodels.define_G(10, 3, 4, "resnet_9blocks").n_blocks == 9
    u = tmodels.define_G(10, 3, 4, "unet_128")
    assert isinstance(u, tmodels.UnetGenerator) and u.n_levels == 7
    assert tmodels.define_G(10, 3, 4, "unet_256").n_levels == 8
    assert tmodels.define_D(9, 4, "basic").n_layers == 3
    assert tmodels.define_D(9, 4, "n_layers", n_layers_D=2).n_layers == 2
    assert isinstance(tmodels.define_D(9, 4, "pixel"),
                      tmodels.PixelDiscriminator)
    with pytest.raises(NotImplementedError, match="Generator model name"):
        tmodels.define_G(10, 3, 4, "resnet_3blocks")
    with pytest.raises(NotImplementedError, match="Discriminator model"):
        tmodels.define_D(9, 4, "global")
    for name in ("ResnetGenerator", "UnetGenerator", "NLayerDiscriminator",
                 "PixelDiscriminator", "GridNet", "LayoutVAE", "LayoutCVAE",
                 "ConvLSTMLayoutPredictor"):
        assert tmodels.get_model_cls(name) is getattr(tmodels, name)
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.get_model_cls("LayoutGAN")
