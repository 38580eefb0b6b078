"""The port's kernel A (prelu_conv3x3) and kernel B (fused_lateral), run
through their plain PyTorch versions on CPU tensors, against the JAX
package's Pallas kernels in interpret mode.

The JAX side takes the 2x2 (or 1x2) packed inputs its kernels were written
for (pack2x2 / pack_kernel3x3) and its output is unpacked; the port takes
the logical NHWC tensors. Everything is f32: the point is the function,
not the rounding. Tolerance atol 1e-4, rtol 1e-4 (f32 sums in another
order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video_layout_generation_tpu.ops.packed import (conv_packed_stride2,
                                                    pack2x2, pack_kernel3x3,
                                                    pack_kernel3x3_stride2,
                                                    unpack2x2)
from video_layout_generation_tpu.ops.pallas import conv_packed
from video_layout_generation_tpu.ops.pallas.conv1x2 import conv3x3_w1x2
from video_layout_generation_tpu.ops.pallas.conv3x3 import conv3x3_pallas
from video_layout_generation_tpu_torch.ops.kernels import (
    fused_lateral, launch_counts, prelu_conv3x3, reset_launch_counts)

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_a(x, w, b, alpha=None, residual=None, stride=1):
    out = prelu_conv3x3(_t(x), _t(w), _t(b),
                        None if alpha is None else torch.tensor(alpha),
                        None if residual is None else _t(residual), stride)
    return out.numpy()


@pytest.mark.parametrize("mode", ["sparse", "prelu", "prelu_res"])
def test_kernel_a_matches_conv_packed(interp, mode):
    c = 32
    x = _rand(2, 16, 16, c, seed=1)
    w = _rand(3, 3, c, c, seed=2, scale=0.05)
    b = _rand(c, seed=3)
    r = _rand(2, 16, 16, c, seed=4)
    alpha = 0.2
    xp, wp = pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w))
    jb, ja = jnp.asarray(b), jnp.asarray(alpha, jnp.float32)
    if mode == "sparse":
        ref = conv_packed.conv_packed3x3_sparse(xp, wp, jb, 4)
        got = _port_a(x, w, b)
    elif mode == "prelu":
        ref = conv_packed.prelu_conv_packed3x3(xp, wp, jb, ja, 4)
        got = _port_a(x, w, b, alpha)
    else:
        ref = conv_packed.prelu_conv_packed3x3_res(
            xp, wp, jb, ja, pack2x2(jnp.asarray(r)), 4)
        got = _port_a(x, w, b, alpha, r)
    np.testing.assert_allclose(got, np.asarray(unpack2x2(ref)), **TOL)


def test_kernel_a_matches_conv1x2(interp):
    x = _rand(1, 8, 16, 64, seed=5)
    w = _rand(3, 3, 64, 64, seed=6, scale=0.05)
    b = _rand(64, seed=7)
    ref = conv3x3_w1x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4)
    np.testing.assert_allclose(_port_a(x, w, b), np.asarray(ref), **TOL)


def test_kernel_a_matches_conv3x3_pallas(interp):
    x = _rand(1, 8, 8, 128, seed=8)
    w = _rand(3, 3, 128, 128, seed=9, scale=0.05)
    b = _rand(128, seed=10)
    ref = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4)
    np.testing.assert_allclose(_port_a(x, w, b), np.asarray(ref), **TOL)


def test_kernel_a_stride2_matches_packed_stride2():
    # DownSamplingBlock.Conv_0: the JAX package runs it as a VALID conv on
    # the packed row-0 tensor (XLA; no Pallas kernel)
    x = _rand(2, 16, 16, 32, seed=11)
    w = _rand(3, 3, 32, 64, seed=12, scale=0.05)
    b = _rand(64, seed=13)
    ref = conv_packed_stride2(pack2x2(jnp.asarray(x)),
                              pack_kernel3x3_stride2(jnp.asarray(w)),
                              jnp.asarray(b))
    got = _port_a(x, w, b, stride=2)
    assert got.shape == (2, 8, 8, 64)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_residual", [False, True])
def test_kernel_b_matches_fused_lateral(interp, with_residual):
    c = 32
    x = _rand(2, 16, 16, c, seed=14)
    w0 = _rand(3, 3, c, c, seed=15, scale=0.2)
    w1 = _rand(3, 3, c, c, seed=16, scale=0.2)
    b0 = _rand(c, seed=17, scale=0.1)
    b1 = _rand(c, seed=18, scale=0.1)
    r = _rand(2, 16, 16, c, seed=19) if with_residual else None
    a0, a1 = 0.25, 0.1
    ref = conv_packed.fused_lateral_packed3x3(
        pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w0)),
        jnp.asarray(b0), jnp.asarray(a0), pack_kernel3x3(jnp.asarray(w1)),
        jnp.asarray(b1), jnp.asarray(a1),
        None if r is None else pack2x2(jnp.asarray(r)), tile_h=2)
    got = fused_lateral(_t(x), _t(w0), _t(b0), torch.tensor(a0), _t(w1),
                        _t(b1), torch.tensor(a1),
                        None if r is None else _t(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack2x2(ref)),
                               **TOL)


@pytest.mark.parametrize("ci,co", [(8, 32), (12, 32), (32, 20), (32, 3)])
def test_kernel_a_gridnet_edge_widths(ci, co):
    # input stems (8, 10+2 coordinate channels) and the two heads
    x = _rand(1, 8, 8, ci, seed=20)
    w = _rand(3, 3, ci, co, seed=21, scale=0.1)
    b = _rand(co, seed=22)
    xn = np.where(x >= 0, x, 0.3 * x)
    ref = torch.nn.functional.conv2d(
        _t(xn).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1), _t(b),
        padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_port_a(x, w, b, 0.3), ref.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    reset_launch_counts()
    x = torch.zeros(1, 4, 4, 8)
    prelu_conv3x3(x, torch.zeros(3, 3, 8, 8), torch.zeros(8))
    assert launch_counts() == {"prelu_conv3x3": 0, "fused_lateral": 0,
                               "ssim_loss": 0, "instance_norm_fwd": 0,
                               "instance_norm_fwd_only": 0,
                               "instance_norm_bwd": 0}


def _graph_nodes(t: torch.Tensor) -> set:
    """The names of the autograd nodes behind ``t``."""
    names, seen, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_plain_mode_routes_every_wrapper_to_its_plain_version():
    """Under ``kernels.plain()`` no kernel's autograd Function is in the
    graph of a GridNet, a ResnetGenerator or an SSIM loss: every wrapper
    returned its plain version. The forward values stay the same on the
    CPU. The mode nests and is restored after an exception."""
    from video_layout_generation_tpu_torch.models import (GridNet,
                                                          ResnetGenerator)
    from video_layout_generation_tpu_torch.ops import kernels
    torch.manual_seed(0)
    x = torch.randn(1, 16, 16, 8)
    y = torch.rand(1, 16, 16, 3)
    cases = [(GridNet(n_channels=8, filters_level=(4, 6, 8)),
              {"_PreluConv3x3Backward", "_FusedLateralBackward"}),
             (ResnetGenerator(input_nc=8, ngf=4, n_blocks=1),
              {"InstanceNormFunctionBackward"}),
             (lambda z: (kernels.ssim_loss(z[..., :3].sigmoid(), y),
                         z.sum()), {"_SsimPlanesBackward"})]
    for net, functions in cases:
        z = x.clone().requires_grad_(True)
        seg, img = net(z)
        assert _graph_nodes(seg.sum() + img.sum()) >= functions
        with kernels.plain():
            seg_p, img_p = net(z)
        assert not _graph_nodes(seg_p.sum() + img_p.sum()) & functions
        assert torch.equal(seg_p, seg) and torch.equal(img_p, img)

    assert not kernels.plain_active()
    with kernels.plain():
        assert kernels.plain_active()
        with kernels.plain(False):
            assert not kernels.plain_active()
        assert kernels.plain_active()
        with pytest.raises(RuntimeError, match="inside"):
            with kernels.plain(False):
                raise RuntimeError("inside")
        assert kernels.plain_active()
    assert not kernels.plain_active()


def test_kernel_a_rejects_other_strides():
    with pytest.raises(ValueError, match="stride"):
        prelu_conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 8),
                      torch.zeros(8), stride=3)


# ---- the tensor-core kernels' host side: plan, weight pack, K order --------

from video_layout_generation_tpu_torch.ops.kernels import (  # noqa: E402
    fused_lateral_plain, prelu_conv3x3_plain)
from video_layout_generation_tpu_torch.ops.kernels import conv3x3 as ka  # noqa: E402
from video_layout_generation_tpu_torch.ops.kernels import lateral as kb  # noqa: E402

_VGG = [(3, 64, 256), (64, 64, 256), (64, 128, 128), (128, 128, 128),
        (128, 256, 64), (256, 256, 64), (256, 512, 32), (512, 512, 32),
        (512, 512, 16)]


def _conv_shapes():
    """(h, ci, co, stride) of every kernel A launch of GridNet (8-, 10- and
    12-channel stems, rows 32/64/96, both heads), HNED and VGG19 at 256x256,
    and of their data gradients (channels swapped)."""
    grid = [(256, ci, 32, 1) for ci in (8, 10, 12)]
    grid += [(256, 32, 32, 1), (128, 64, 64, 1), (64, 96, 96, 1),
             (256, 32, 64, 2), (128, 64, 64, 1), (128, 64, 96, 2),
             (64, 96, 96, 1), (128, 96, 64, 1), (256, 64, 32, 1),
             (256, 32, 20, 1), (256, 32, 3, 1)]
    relu = [(h, ci, co, 1) for ci, co, h in _VGG]
    dgrad = [(h, co, ci, 1) for ci, co, h in _VGG] + [(256, 20, 32, 1)]
    return sorted(set(grid + relu + dgrad))


def _covered_once(extent, tile, blocks):
    count = np.zeros(extent, np.int64)
    for b in range(blocks):
        count[b * tile:(b + 1) * tile] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("h,ci,co,stride", _conv_shapes())
def test_conv_plan_fits_and_covers(batch, h, ci, co, stride):
    plan = ka.conv_plan(batch, h, h, ci, co, stride)
    assert plan["smem"] <= 113 * 1024          # two blocks an SM
    th, tw = plan["tile"]
    assert plan["smem"] == (ka.scratch_bytes(plan["bn"]) + plan["stages"]
                            * ka.stage_bytes(plan["bn"], stride, th))
    assert 2 <= plan["stages"] <= 4 and plan["bn"] in (32, 64)
    # shared memory does not grow with the depth of the input
    assert plan["smem"] == ka.conv_plan(batch, h, h, 8 * ci, co,
                                        stride)["smem"]
    ho = (h - 1) // stride + 1
    assert th in ka.TILE_ROWS and tw == ka.TILE_W
    tiles_h, tiles_w = -(-ho // th), -(-ho // tw)
    assert plan["grid"][0] == batch * tiles_h * tiles_w
    assert _covered_once(ho, th, tiles_h) and _covered_once(ho, tw, tiles_w)
    assert _covered_once(co, plan["bn"], plan["grid"][1])
    # the persistent blocks: every item has a block, no block is idle, and
    # what the plan asks of an SM fits it
    items = plan["grid"][0] * plan["grid"][1]
    assert 1 <= plan["blocks"] <= items
    runs = [(items * b // plan["blocks"], items * (b + 1) // plan["blocks"])
            for b in range(plan["blocks"])]     # as the kernel cuts them
    assert runs[0][0] == 0 and runs[-1][1] == items
    assert all(a < b for a, b in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    per_sm = -(-plan["blocks"] // ka.N_SM)
    assert per_sm * (plan["smem"] + 1024) <= ka.SMEM_PER_SM
    assert plan["chunks"] * ka.CHUNK >= ci > (plan["chunks"] - 1) * ka.CHUNK


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("h,c", [(256, 32), (128, 64), (64, 96), (37, 40)])
def test_lateral_plan_fits_and_covers(batch, h, c):
    plan = kb.lateral_plan(batch, h, h, c)
    assert plan["smem"] <= 113 * 1024
    tiles = -(-h // kb.TILE)
    assert plan["grid"] == (batch * tiles * tiles, 1)
    assert 1 <= plan["blocks"] <= plan["grid"][0]
    per_sm = -(-plan["blocks"] // ka.N_SM)
    assert per_sm <= kb.MAX_BLOCKS_PER_SM
    assert per_sm * (plan["smem"] + 1024) <= ka.SMEM_PER_SM
    assert _covered_once(h, kb.TILE, tiles)
    assert plan["steps"] == 2 * (-(-c // 16)) * (-(-c // 32))
    assert kb.MID % 16 == 0 and abs(kb.RECOMPUTE - 256 / 196) < 1e-12


def test_plans_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="stride"):
        ka.conv_plan(1, 8, 8, 8, 8, 3)
    with pytest.raises(ValueError, match="empty"):
        ka.conv_plan(0, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="empty"):
        kb.lateral_plan(1, 0, 8, 8)


@pytest.mark.parametrize("co", [3, 20, 64])
@pytest.mark.parametrize("ci", [3, 8, 20, 32, 96])
def test_weight_pack_round_trip(ci, co):
    w = _t(_rand(3, 3, ci, co, seed=ci * 100 + co))
    p = ka.pack_weights(w)
    assert p.shape == (3, 3, ci, -(-co // 8) * 8) and p.is_contiguous()
    assert torch.equal(p[..., :co], w) and not p[..., co:].any()
    pt = ka.pack_weights(w, transposed=True)
    assert pt.shape == (3, 3, co, -(-ci // 8) * 8) and pt.is_contiguous()
    assert torch.equal(pt[..., :ci], w.flip(0, 1).transpose(2, 3))
    assert not pt[..., ci:].any()
    # the data gradient of the conv is the conv with the transposed pack
    x = _t(_rand(1, 5, 6, ci, seed=1)).requires_grad_(True)
    dy = _t(_rand(1, 5, 6, co, seed=2))
    y = prelu_conv3x3_plain(x, w, torch.zeros(co))
    dx, = torch.autograd.grad(y, x, dy)
    got = prelu_conv3x3_plain(dy, pt[..., :ci].contiguous(), torch.zeros(ci))
    np.testing.assert_allclose(got.numpy(), dx.numpy(), **TOL)


@pytest.mark.parametrize("transposed", [False, True])
def test_packed_weights_cache_follows_the_version(transposed):
    w = torch.nn.Parameter(_t(_rand(3, 3, 8, 20, seed=3)))
    first = ka.packed_weights(w, transposed)
    assert ka.packed_weights(w, transposed) is first        # cached
    with torch.no_grad():
        w.mul_(2.0)                                        # as Adam updates
    second = ka.packed_weights(w, transposed)
    assert second is not first
    assert torch.equal(second, ka.pack_weights(w.detach(), transposed))
    key = (id(w), transposed)
    assert key in ka._PACKS
    del w
    assert key not in ka._PACKS                            # went with it


def test_packed_weights_passes_an_aligned_kernel_through():
    w = _t(_rand(3, 3, 8, 32, seed=4))
    assert ka.packed_weights(w) is w
    assert ka.packed_weights(w, transposed=True) is not w


def _conv_in_kernel_order(x, w, alpha=None, stride=1):
    """f32 emulation of the CUDA kernels' sum: the input and the packed
    weights padded with zero channels to whole chunks, partial sums added
    chunk by chunk and, within a chunk, tap by tap. No bias."""
    wp = ka.pack_weights(w)
    n, h, wd, ci = x.shape
    co_pad = wp.shape[-1]
    chunks = ka.conv_plan(n, h, wd, ci, w.shape[-1], stride)["chunks"]
    if alpha is not None:
        x = torch.where(x >= 0, x, alpha * x)
    pad_c = chunks * ka.CHUNK - ci
    xp = torch.nn.functional.pad(x, (0, pad_c, 1, 1, 1, 1))
    wp = torch.nn.functional.pad(wp, (0, 0, 0, pad_c))
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    acc = torch.zeros(n, ho, wo, co_pad)
    for c in range(chunks):
        ch = slice(c * ka.CHUNK, (c + 1) * ka.CHUNK)
        for ky in range(3):
            for kx in range(3):
                win = xp[:, ky:ky + (ho - 1) * stride + 1:stride,
                         kx:kx + (wo - 1) * stride + 1:stride, ch]
                acc = acc + win @ wp[ky, kx, ch]
    return acc[..., :w.shape[-1]]


def _emulated_a(x, w, b, alpha=None, residual=None, stride=1):
    y = _conv_in_kernel_order(_t(x), _t(w), alpha, stride) + _t(b)
    if residual is not None:
        y = y + _t(residual)
    return y.numpy()


@pytest.mark.parametrize("ci,co,stride", [(3, 64, 1), (8, 32, 1), (24, 20, 1),
                                          (24, 20, 2), (20, 3, 1),
                                          (96, 96, 1), (32, 64, 2)])
def test_kernel_order_emulation_matches_plain(ci, co, stride):
    x = _rand(2, 9, 11, ci, seed=30)
    w = _rand(3, 3, ci, co, seed=31, scale=0.1)
    b = _rand(co, seed=32)
    ho, wo = (9 - 1) // stride + 1, (11 - 1) // stride + 1
    r = _rand(2, ho, wo, co, seed=33)
    want = prelu_conv3x3_plain(_t(x), _t(w), _t(b), torch.tensor(0.3), _t(r),
                               stride).numpy()
    np.testing.assert_allclose(_emulated_a(x, w, b, 0.3, r, stride), want,
                               **TOL)


def test_kernel_order_emulation_matches_jax_kernels(interp):
    c = 32
    x = _rand(2, 16, 16, c, seed=1)
    w = _rand(3, 3, c, c, seed=2, scale=0.05)
    b = _rand(c, seed=3)
    r = _rand(2, 16, 16, c, seed=4)
    ref = conv_packed.prelu_conv_packed3x3_res(
        pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w)),
        jnp.asarray(b), jnp.asarray(0.2, jnp.float32),
        pack2x2(jnp.asarray(r)), 4)
    np.testing.assert_allclose(_emulated_a(x, w, b, 0.2, r),
                               np.asarray(unpack2x2(ref)), **TOL)
    x = _rand(1, 8, 16, 64, seed=5)
    w = _rand(3, 3, 64, 64, seed=6, scale=0.05)
    b = _rand(64, seed=7)
    ref = conv3x3_w1x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4)
    np.testing.assert_allclose(_emulated_a(x, w, b), np.asarray(ref), **TOL)


def _emulated_b(x, w0, b0, a0, w1, b1, a1, residual=None):
    """Kernel B as its blocks compute it, in f32: per 14 x 14 output tile,
    conv0 in the kernel's K order over the 16 x 16 intermediate from the
    18 x 18 input window, bias, PReLU1, zero outside the image, then conv1
    over that tile alone."""
    x, w0, w1 = _t(x), _t(w0), _t(w1)
    n, h, wd, c = x.shape
    t = kb.TILE
    xp = torch.nn.functional.pad(x, (0, 0, 2, t + 2, 2, t + 2))
    out = torch.zeros(n, -(-h // t) * t, -(-wd // t) * t, c)
    ys = torch.arange(kb.MID)
    for oy in range(0, h, t):
        for ox in range(0, wd, t):
            win = xp[:, oy:oy + t + 4, ox:ox + t + 4]          # 18 x 18
            # a VALID conv of the window: the emulation pads by 1, cut it
            mid = _conv_in_kernel_order(win, w0, a0)[:, 1:-1, 1:-1] + _t(b0)
            mid = torch.where(mid >= 0, mid, a1 * mid)
            inside = (((ys + oy - 1 >= 0) & (ys + oy - 1 < h))[:, None]
                      & ((ys + ox - 1 >= 0) & (ys + ox - 1 < wd))[None, :])
            mid = mid * inside[None, :, :, None]
            y = _conv_in_kernel_order(mid, w1)[:, 1:-1, 1:-1] + _t(b1)
            out[:, oy:oy + t, ox:ox + t] = y
    out = out[:, :h, :wd]
    if residual is not None:
        out = out + _t(residual)
    return out.numpy()


@pytest.mark.parametrize("c,with_residual", [(32, True), (40, False)])
def test_kernel_b_tile_emulation_matches_plain_and_jax(interp, c,
                                                       with_residual):
    h, wd = (16, 16) if c == 32 else (17, 30)     # the second one ragged
    x = _rand(2, h, wd, c, seed=14)
    w0 = _rand(3, 3, c, c, seed=15, scale=0.2)
    w1 = _rand(3, 3, c, c, seed=16, scale=0.2)
    b0 = _rand(c, seed=17, scale=0.1)
    b1 = _rand(c, seed=18, scale=0.1)
    r = _rand(2, h, wd, c, seed=19) if with_residual else None
    a0, a1 = 0.25, 0.1
    got = _emulated_b(x, w0, b0, a0, w1, b1, a1, r)
    want = fused_lateral_plain(_t(x), _t(w0), _t(b0), torch.tensor(a0),
                               _t(w1), _t(b1), torch.tensor(a1),
                               None if r is None else _t(r))
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    if c == 32:
        ref = conv_packed.fused_lateral_packed3x3(
            pack2x2(jnp.asarray(x)), pack_kernel3x3(jnp.asarray(w0)),
            jnp.asarray(b0), jnp.asarray(a0), pack_kernel3x3(jnp.asarray(w1)),
            jnp.asarray(b1), jnp.asarray(a1), pack2x2(jnp.asarray(r)),
            tile_h=2)
        np.testing.assert_allclose(got, np.asarray(unpack2x2(ref)), **TOL)


def test_packed_weights_never_caches_an_inference_tensor():
    with torch.inference_mode():
        w = _t(_rand(3, 3, 8, 20, seed=5)).clone()
        first = ka.packed_weights(w)
        w.mul_(2.0)                  # no version counter to see this
        second = ka.packed_weights(w)
    assert (id(w), False) not in ka._PACKS
    assert torch.equal(second, 2.0 * first)


def test_conv_module_casts_to_a_normal_tensor_under_inference_mode():
    from video_layout_generation_tpu_torch.models.blocks import Conv3x3
    conv = Conv3x3(8, 20)
    with torch.inference_mode():
        cast = conv.weight(torch.bfloat16)
    assert not cast.is_inference() and cast.dtype == torch.bfloat16
    assert ka.packed_weights(cast) is ka.packed_weights(cast)
