"""The InstanceNorm kernel's launch plan and its order of summation, on the CPU.

``instance_norm_plan`` (``ops/kernels/instance_norm.py``) decides on the host
how ``csrc/instance_norm.cu`` runs a call: channel tiles, one cluster of CTAs
for each (n, tile) slice, the pixels of each CTA and how many of them it holds
in shared memory. It is held here at every InstanceNorm shape of the pix2pix
generator (ngf 64, 9 blocks) and PatchGAN (ndf 64, 3 layers) at batch 16, 4
and 1 and at a ragged shape.

``emulate_forward`` / ``emulate_backward`` repeat the kernel's order of
summation in f32 with numpy (a thread's rows in ascending order, an xor
butterfly over a warp's rows, the warps in ascending order, the CTAs' chunk
statistics merged in rank order with the centered formula) on the plan's own
cut, and are held against the JAX package's XLA formula and its Pallas
kernels in interpret mode. Tolerances: 1e-5 in f32 (sums in another order),
3e-2 absolute for bf16 outputs of order 1 (a bf16 ulp is 8e-3 at 2).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.ops.pallas import instance_norm as jin
from video_layout_generation_tpu_torch.ops.kernels import \
    instance_norm as tin

GEN = [(256, 256, 64), (128, 128, 128), (64, 64, 256)]     # ResnetGenerator
DISC = [(64, 64, 128), (32, 32, 256), (31, 31, 512)]      # NLayerDiscriminator
PLAN_SHAPES = ([(b,) + s for s in GEN + DISC for b in (16, 4, 1)]
               + [(3, 17, 23, 20)])
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_covers_every_value_once_within_the_card(shape, dtype,
                                                      backward):
    n, h, w, c = shape
    hw = h * w
    p = tin.instance_norm_plan(n, h, w, c, DTYPES[dtype], backward)
    esize = 2 if dtype == "bfloat16" else 4
    assert p["vec"] == (16 // esize if c % (16 // esize) == 0 else 1)
    lanes = p["ct"] // p["vec"]
    assert p["ct"] % p["vec"] == 0 and lanes & (lanes - 1) == 0
    assert 1 <= lanes <= tin.MAX_LANES
    # shared memory of one block, clusters the card can form
    assert p["smem"] == tin.smem_bytes(p["ct"], p["held"], esize,
                                       2 if backward else 1)
    assert p["smem"] <= tin.SMEM_MAX == 232448
    assert 1 <= p["k"] <= tin.MAX_CLUSTER == 16
    # a CTA holds no more than the largest CTA the plan allows, one row more
    row = p["ct"] * esize * (2 if backward else 1)
    assert p["held"] * row <= max(tin.CTA_BYTES) + row
    assert p["ctiles"] == -(-c // p["ct"])
    # every pixel of a plane in exactly one CTA, none of them empty
    owned = np.zeros(hw, int)
    for rank in range(p["k"]):
        lo, hi = rank * p["rows"], min(hw, (rank + 1) * p["rows"])
        assert hi > lo
        owned[lo:hi] += 1
    assert (owned == 1).all()
    # every channel in exactly one tile
    tiles = np.zeros(c, int)
    for t in range(p["ctiles"]):
        tiles[t * p["ct"]:(t + 1) * p["ct"]] += 1
    assert (tiles == 1).all()
    assert 0 <= p["held"] <= p["rows"]
    assert (p["regime"] == "resident") == (p["held"] == p["rows"])
    # the shapes that carry a train step's time are held on chip
    if dtype == "bfloat16" and n == 16 and h in (64, 128):
        assert p["regime"] == "resident"


def test_plan_streams_a_slice_no_cluster_holds_and_refuses_bad_input():
    p = tin.instance_norm_plan(1, 512, 512, 8, torch.bfloat16, True)
    assert p["regime"] == "streaming" and p["k"] == tin.MAX_CLUSTER
    assert p["held"] < p["rows"] and p["smem"] <= tin.SMEM_MAX
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tin.instance_norm_plan(1, 4, 4, 8, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        tin.instance_norm_plan(1, 0, 4, 8, torch.float32)


# ---- the kernel's order of summation --------------------------------------

def _cta_sum(vals, lanes):
    """One CTA's sums over its rows, (rows, ct) f32 -> (ct,) f32, in the
    kernel's order: thread ty takes rows ty, ty + ty_n, ... ascending; a
    warp's rows by an xor butterfly; the warps ascending."""
    ty_n = tin.NTHREADS // lanes
    rows, ct = vals.shape
    steps = -(-rows // ty_n)
    pad = np.zeros((steps * ty_n, ct), np.float32)
    pad[:rows] = vals
    acc = np.zeros((ty_n, ct), np.float32)
    for j in range(steps):
        acc = acc + pad[j * ty_n:(j + 1) * ty_n]
    per_warp = 32 // lanes
    acc = acc.reshape(tin.NWARPS, per_warp, ct)
    off = 1
    while off < per_warp:
        acc = acc + acc[:, np.arange(per_warp) ^ off]
        off *= 2
    total = np.zeros(ct, np.float32)
    for wv in range(tin.NWARPS):
        total = total + acc[wv, 0]
    return total


def _slices(plan, hw, c):
    """(tile channels, [(rank, first row, rows)]) of the plan's cut."""
    ranks = [(r, r * plan["rows"], min(hw, (r + 1) * plan["rows"])
              - r * plan["rows"]) for r in range(plan["k"])]
    for t in range(plan["ctiles"]):
        yield slice(t * plan["ct"], min(c, (t + 1) * plan["ct"])), ranks


def emulate_forward(x, plan, eps=1e-5):
    """y (f32) and rstd (n, c) of an (n, hw, c) f32 array, computed as the
    kernel does on ``plan``'s cut."""
    n, hw, c = x.shape
    lanes = plan["ct"] // plan["vec"]
    y = np.empty_like(x)
    rstd = np.empty((n, c), np.float32)
    for i in range(n):
        for chans, ranks in _slices(plan, hw, c):
            s, q, cnt = [], [], []
            for _, r0, m in ranks:
                v = x[i, r0:r0 + m, chans]
                sk = _cta_sum(v, lanes)
                mu = sk / np.float32(m)          # a true division
                d = v - mu
                q.append(_cta_sum(d * d, lanes))
                s.append(sk)
                cnt.append(np.float32(m))
            total = np.zeros_like(s[0])
            for sk in s:
                total = total + sk
            mean = total / np.float32(hw)
            m2 = np.zeros_like(total)
            for sk, qk, nk in zip(s, q, cnt):
                d = sk / nk - mean
                m2 = m2 + (qk + nk * d * d)
            rs = np.float32(1) / np.sqrt(m2 / np.float32(hw)
                                         + np.float32(eps))
            rstd[i, chans] = rs
            y[i, :, chans] = (x[i, :, chans] - mean) * rs
    return y, rstd


def emulate_backward(dy, y, rstd, plan):
    """dx (f32) of (n, hw, c) f32 arrays, computed as the kernel does."""
    n, hw, c = dy.shape
    lanes = plan["ct"] // plan["vec"]
    dx = np.empty_like(dy)
    for i in range(n):
        for chans, ranks in _slices(plan, hw, c):
            a = np.zeros(chans.stop - chans.start, np.float32)
            b = np.zeros_like(a)
            for _, r0, m in ranks:
                g, v = dy[i, r0:r0 + m, chans], y[i, r0:r0 + m, chans]
                a = a + _cta_sum(g, lanes)
                b = b + _cta_sum(g * v, lanes)
            ma, mb = a / np.float32(hw), b / np.float32(hw)
            dx[i, :, chans] = rstd[i, chans] * (
                dy[i, :, chans] - ma - y[i, :, chans] * mb)
    return dx


def _input(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "constant":      # exact in bf16, and so is every sum of it
        return np.broadcast_to(1.0 + 0.5 * (np.arange(shape[-1]) % 7),
                               shape).astype(np.float32)
    x = rng.standard_normal(shape) * 1.5
    offset = 100.0 if kind == "large mean" else 2.0
    x = x + offset * rng.standard_normal((shape[0], 1, 1, shape[-1]))
    return x.astype(np.float32)


def _round(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype]).float().numpy()


FWD_CASES = [((2, 8, 8, 256), "float32", "random"),
             ((2, 8, 8, 256), "bfloat16", "random"),
             ((1, 16, 16, 128), "float32", "random"),
             ((3, 17, 23, 20), "float32", "random"),
             ((3, 17, 23, 20), "bfloat16", "random"),
             ((2, 16, 16, 128), "float32", "constant"),
             ((2, 16, 16, 128), "bfloat16", "constant"),
             ((1, 31, 31, 16), "bfloat16", "large mean")]


@pytest.mark.parametrize("shape,dtype,kind", FWD_CASES)
def test_emulated_forward_matches_xla_and_the_pallas_kernel(
        shape, dtype, kind, interpret):
    n, h, w, c = shape
    plan = tin.instance_norm_plan(n, h, w, c, DTYPES[dtype])
    x = _round(_input(shape, kind, seed=sum(shape)), dtype)
    y, rstd = emulate_forward(x.reshape(n, h * w, c), plan)
    y = _round(y, dtype).reshape(shape)
    atol = 1e-5 if dtype == "float32" else 3e-2
    if kind == "constant":
        assert float(np.abs(y).max()) == 0.0
        return
    xj = jnp.asarray(x).astype(dtype)
    refs = [jin._xla_instance_norm(xj, 1e-5)]
    if jin._tileable(shape):
        y_ref, (_, rstd_ref) = jin._pallas_fwd(xj, 1e-5)
        refs += [y_ref, jin._pallas_fwd_only(xj, 1e-5)]
        np.testing.assert_allclose(rstd, np.asarray(rstd_ref)[:, 0, 0, :],
                                   rtol=1e-5)
    # the variance of a plane with mean 100 survives bf16 inputs: against
    # the exact statistics of the same rounded values
    xf = x.astype(np.float64)
    exact = 1 / np.sqrt(xf.var(axis=(1, 2)) + 1e-5)
    np.testing.assert_allclose(rstd, exact, rtol=1e-4)
    for ref in refs:
        np.testing.assert_allclose(y, np.asarray(ref.astype(jnp.float32)),
                                   atol=atol)


BWD_CASES = [((2, 8, 8, 256), "float32"), ((1, 16, 16, 128), "float32"),
             ((2, 8, 8, 128), "bfloat16"), ((3, 17, 23, 20), "float32")]


@pytest.mark.parametrize("shape,dtype", BWD_CASES)
def test_emulated_backward_matches_the_pallas_kernel(shape, dtype,
                                                     interpret):
    n, h, w, c = shape
    plan = tin.instance_norm_plan(n, h, w, c, DTYPES[dtype], True)
    x = _round(_input(shape, "random", seed=sum(shape) + 1), dtype)
    dy = _round(np.random.default_rng(3).standard_normal(shape)
                .astype(np.float32), dtype)
    y, rstd = emulate_forward(x.reshape(n, h * w, c), plan)
    y = _round(y, dtype)
    dx = emulate_backward(dy.reshape(n, h * w, c), y, rstd, plan)
    dx = _round(dx, dtype).reshape(shape)
    # the closed form in f64 on the same inputs
    want = tin.instance_norm_bwd_plain(
        torch.from_numpy(dy).double(),
        torch.from_numpy(y.reshape(shape)).double(),
        torch.from_numpy(rstd).double()).numpy()
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(dx, want, atol=atol)
    if jin._tileable(shape):
        dx_ref, = jin._pallas_bwd(
            (jnp.asarray(y.reshape(shape)).astype(dtype),
             jnp.asarray(rstd)[:, None, None, :]),
            jnp.asarray(dy).astype(dtype))
        np.testing.assert_allclose(dx, np.asarray(dx_ref, np.float32),
                                   atol=atol)
