"""The SSIM kernel's launch plan and its order of summation, on the CPU.

``ssim_plan`` (``ops/kernels/ssim.py``) decides on the host how
``csrc/ssim.cu`` runs a call: one cluster of K CTAs per image, the output
rows of each CTA, the passes over a flat row (``tile`` columns each), the
ring of streamed rows, the threads and their columns. It is held here at the
validation step's shape (16, 256, 256, 3) in f32 and bf16, at batch 1, at
ragged shapes and at the shapes of ``tests/test_torch_ssim.py``.

``emulate`` repeats the kernel's arithmetic and order of summation in f32
with numpy (the horizontal sums of a row, the three rows of a window summed
oldest first, the non-contracting SSIM formula, a thread's per-column sums
over its rows pass after pass, the CTA's column groups summed per channel
in groups of ``group``, the CTAs' channel sums merged in rank order) on the
plan's own cut, and is held against the JAX package's Pallas kernel in
interpret mode and its XLA formula at atol 1e-6 (sums in another order;
per-plane values lie in [0, 1]).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video_layout_generation_tpu.losses.ssim import ssim_loss as jax_ssim
from video_layout_generation_tpu.ops.pallas import ssim as jax_kernel
from video_layout_generation_tpu_torch.ops.kernels import ssim as tk

EVAL = (16, 256, 256, 3)
PLAN_CASES = [(EVAL, "float32"), (EVAL, "bfloat16"),
              ((1, 256, 256, 3), "float32"), ((1, 256, 256, 3), "bfloat16"),
              ((5, 130, 94, 3), "float32"), ((5, 130, 94, 3), "bfloat16"),
              ((3, 9, 21, 3), "float32"), ((3, 9, 21, 3), "bfloat16"),
              ((1, 3, 3, 1), "float32"), ((1, 3, 3, 1), "bfloat16"),
              ((2, 32, 32, 5), "float32"), ((2, 32, 32, 5), "bfloat16"),
              # rows wider than one pass
              ((1, 8, 2000, 3), "float32"), ((2, 5, 700, 7), "bfloat16"),
              ((1, 4, 12, 1024), "float32")]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interp(monkeypatch):
    """Run the JAX package's Pallas kernel in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _segments(plan, n, h, w, c, esize):
    """(first byte, end byte) of every (pass, row) segment a CTA streams,
    from an image base on 16 bytes, with its CTA's rank and output rows."""
    row_len = w * c
    for i in range(n):
        for rank in range(plan["k"]):
            r0 = rank * plan["rows"]
            cnt = min(h - 2, r0 + plan["rows"]) - r0
            for t in range(plan["tiles"]):
                col0 = t * plan["tile"]
                seg = min(plan["tile"] + 2 * c, row_len - col0)
                for r in range(r0, r0 + cnt + 2):
                    g0 = ((i * h + r) * row_len + col0) * esize
                    yield rank, t, r, g0, g0 + seg * esize


@pytest.mark.parametrize("shape,dtype", PLAN_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{d}"
                              for s, d in PLAN_CASES])
def test_plan_covers_every_output_once_within_the_card(shape, dtype):
    n, h, w, c = shape
    esize = 2 if dtype == "bfloat16" else 4
    p = tk.ssim_plan(n, h, w, c, DTYPES[dtype])
    out_rows, out_cols = h - 2, (w - 2) * c
    # clusters the card can form, one CTA an SM at most for a batch
    assert 1 <= p["k"] <= tk.MAX_CLUSTER == 16
    assert n * p["k"] <= max(tk.N_SM, n)
    # every output row in exactly one CTA, none of them empty
    owned = np.zeros(out_rows, int)
    for rank in range(p["k"]):
        lo, hi = rank * p["rows"], min(out_rows, (rank + 1) * p["rows"])
        assert hi > lo
        owned[lo:hi] += 1
    assert (owned == 1).all()
    # every flat output column in exactly one pass; a pass keeps channels
    assert p["tile"] % c == 0 and p["tiles"] == -(-out_cols // p["tile"])
    cols = np.zeros(out_cols, int)
    for t in range(p["tiles"]):
        cols[t * p["tile"]:(t + 1) * p["tile"]] += 1
    assert (cols == 1).all()
    # threads: whole warps, each column of a pass owned by one of them
    assert p["threads"] % 32 == 0
    assert p["threads"] <= tk.MAX_THREADS
    assert p["tile"] <= p["threads"] * tk.COLS < p["tile"] + 32 * tk.COLS
    # shared memory of one block, the ring, the reduction's cut
    assert tk.MIN_STAGES <= p["stages"] <= tk.MAX_STAGES
    groups = p["tile"] // c
    assert p["parts"] == -(-groups // p["group"])
    assert (p["group"] - 1) ** 2 < groups <= p["group"] ** 2
    assert p["smem"] == tk.smem_bytes(p["stages"], p["tile"], c, esize,
                                      p["parts"])
    assert p["smem"] <= tk.SMEM_MAX == 232448
    # halo rows: a CTA streams its output rows and the 2 below, so every
    # output row's window lies in its own CTA's rows
    streamed = {}
    aligned = True
    for rank, t, r, g0, g1 in _segments(p, min(n, 2), h, w, c, esize):
        streamed.setdefault((rank, t), []).append(r)
        # the copy: a 16-byte aligned bulk middle, the ends value by value
        a = min(-(-g0 // 16) * 16, g1)
        b = max(g1 // 16 * 16, a)
        assert g0 <= a <= b <= g1 and a % 16 == 0 or a == b
        assert (b - a) % 16 == 0 and a - g0 < 16 and g1 - b < 16
        # the ends fit the producer's 15 lanes a tensor, and the slot
        assert (a - g0) // esize + (g1 - b) // esize <= 15
        assert (g0 % 16) + (g1 - g0) <= tk.slot_bytes(p["tile"], c, esize)
        assert g0 % p["align"] == 0 and g1 % p["align"] == 0
        aligned &= g0 % 16 == 0 and g1 % 16 == 0
    assert aligned == (p["align"] == 16)
    for (rank, t), rows in streamed.items():
        r0 = rank * p["rows"]
        cnt = min(out_rows, r0 + p["rows"]) - r0
        assert rows == list(range(r0, r0 + cnt + 2)) * min(n, 2)
        assert rows[-1] <= h - 1


# An H100 SXM's GPCs as its cluster counts show them (PERF.md): clusters of
# 8 CTAs, one an SM, fit 15 at once, not 132 // 8 = 16.
H100_GPCS = (18, 18, 18, 18, 18, 16, 16, 10)
H100_CAPACITY = tuple(sum(g // k for g in H100_GPCS) for k in range(1, 17))


def test_eval_shape_plan_fills_the_card_in_one_wave_with_16_byte_rows():
    assert H100_CAPACITY[7] == 15 and H100_CAPACITY[15] == 7
    for dtype in DTYPES.values():
        p = tk.ssim_plan(*EVAL, dtype)          # every SM in any cluster
        assert (p["k"], p["rows"], p["tiles"]) == (8, 32, 1)
        assert p["align"] == 16                  # bulk copies alone
        assert p["smem"] >= tk.ONE_PER_SM        # one CTA an SM
        # on the card 16 clusters of 8 do not fit at once: 6 a cluster do
        q = tk.ssim_plan(*EVAL, dtype, capacity=H100_CAPACITY)
        assert q["k"] == 6 and q["rows"] == 43
        assert EVAL[0] <= H100_CAPACITY[q["k"] - 1]
        # one image: a cluster of 16
        assert tk.ssim_plan(1, 256, 256, 3, dtype,
                            capacity=H100_CAPACITY)["k"] == 16


def test_plan_refuses_bad_input_and_takes_wider_channels_than_before():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.ssim_plan(1, 8, 8, 3, torch.float16)
    with pytest.raises(ValueError, match="H, W >= 3"):
        tk.ssim_plan(1, 2, 8, 3, torch.float32)
    with pytest.raises(ValueError, match="H, W >= 3"):
        tk.ssim_plan(0, 8, 8, 3, torch.float32)
    with pytest.raises(ValueError, match="C <= "):
        tk.ssim_plan(1, 8, 8, tk.MAX_C + 1, torch.float32)
    with pytest.raises(ValueError, match="cluster"):
        tk.ssim_plan(1, 8, 8, 3, torch.float32, k=17)
    with pytest.raises(ValueError, match="multiple"):
        tk.ssim_plan(1, 8, 8, 3, torch.float32, tile=4)
    with pytest.raises(ValueError, match="ring slots"):
        tk.ssim_plan(1, 8, 8, 3, torch.float32, stages=2)
    # the two-kernel design took C up to 675 (its tile's shared memory)
    p = tk.ssim_plan(2, 64, 64, 1024, torch.float32)
    assert p["smem"] <= tk.SMEM_MAX and p["tile"] % 1024 == 0


# ---- the kernel's arithmetic and order of summation -----------------------

F = np.float32
K9 = F(1.0) / F(9.0)
C1 = F(0.01) * F(0.01)
C2 = F(0.03) * F(0.03)


def _ssim_value(sx, sy, sxx, syy, sxy):
    """csrc/ssim.cu:ssim_value in f32, each operation rounded."""
    mx, my = sx * K9, sy * K9
    mxx, myy, mxy = mx * mx, my * my, mx * my
    vx, vy, vxy = sxx * K9 - mxx, syy * K9 - myy, sxy * K9 - mxy
    num = (F(2) * mxy + C1) * (F(2) * vxy + C2)
    den = ((mxx + myy) + C1) * ((vx + vy) + C2)
    v = (F(1) - num / den) * F(0.5)
    return np.minimum(np.maximum(v, F(0)), F(1))


def emulate(x, y, plan):
    """(n, c) f32 plane means of (n, h, w, c) f32 arrays, computed as the
    kernel computes them on ``plan``'s cut."""
    n, h, w, c = x.shape
    out_rows, out_cols, row_len = h - 2, (w - 2) * c, w * c
    xf = x.reshape(n, h, row_len)
    yf = y.reshape(n, h, row_len)
    tile = plan["tile"]
    groups = tile // c
    out = np.empty((n, c), F)
    for i in range(n):
        sums = []
        for rank in range(plan["k"]):
            r0 = rank * plan["rows"]
            cnt = min(out_rows, r0 + plan["rows"]) - r0
            acc = np.zeros(tile, F)            # a thread's column sums
            for t in range(plan["tiles"]):
                col0 = t * tile
                width = min(tile, out_cols - col0)
                xs = xf[i, r0:r0 + cnt + 2, col0:col0 + width + 2 * c]
                ys = yf[i, r0:r0 + cnt + 2, col0:col0 + width + 2 * c]

                def taps(a):
                    return (a[:, :width], a[:, c:c + width],
                            a[:, 2 * c:2 * c + width])
                x0, x1, x2 = taps(xs)
                y0, y1, y2 = taps(ys)
                hs = [(x0 + x1) + x2, (y0 + y1) + y2,
                      (x0 * x0 + x1 * x1) + x2 * x2,
                      (y0 * y0 + y1 * y1) + y2 * y2,
                      (x0 * y0 + x1 * y1) + x2 * y2]
                # rows r-2, r-1, r, oldest first
                vs = [(s[:-2] + s[1:-1]) + s[2:] for s in hs]
                vals = _ssim_value(*vs)
                for r in range(cnt):
                    acc[:width] = acc[:width] + vals[r]
            colsum = acc.reshape(groups, c)
            part = []
            for q in range(plan["parts"]):
                s = np.zeros(c, F)
                for g in range(q * plan["group"],
                               min(groups, (q + 1) * plan["group"])):
                    s = s + colsum[g]
                part.append(s)
            csum = np.zeros(c, F)
            for s in part:
                csum = csum + s
            sums.append(csum)
        total = np.zeros(c, F)
        for s in sums:             # rank 0 merges the cluster in rank order
            total = total + s
        out[i] = total / (F(out_rows) * F(w - 2))
    return out


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 0.2 + 0.5, 0, 1)
    y = np.clip(x + noise * rng.standard_normal(shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# (shape, dtype, plan keywords): the plan's own cut, more CTAs and more
# passes than it would take, and the tests' own shapes
# The JAX side compiles each new shape (about 1 s): it is run on the cases
# marked True, the others are held against the port's plain version, which
# tests/test_torch_ssim.py holds against both.
EMU_CASES = [((2, 16, 16, 3), "float32", {}, True),
             ((3, 9, 21, 3), "float32", {}, False),
             ((1, 3, 3, 1), "float32", {}, False),
             ((2, 32, 32, 5), "float32", {}, False),
             ((2, 32, 32, 5), "bfloat16", {}, False),
             ((1, 24, 8, 3), "float32", {"k": 5}, True),
             ((2, 13, 40, 3), "float32", {"k": 4, "tile": 24}, True),
             ((1, 11, 30, 5), "bfloat16", {"k": 3, "tile": 35}, True)]


@pytest.mark.parametrize("shape,dtype,kw,against_jax", EMU_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{d}-{len(kw)}"
                              for s, d, kw, _ in EMU_CASES])
def test_emulated_kernel_matches_pallas_and_xla(interp, shape, dtype, kw,
                                                against_jax):
    x, y = _pair(shape, seed=11)
    if dtype == "bfloat16":
        x, y = _bf16(x), _bf16(y)
    n, h, w, c = shape
    plan = tk.ssim_plan(n, h, w, c, DTYPES[dtype], **kw)
    got = emulate(x, y, plan)
    assert got.dtype == np.float32 and got.shape == (n, c)
    loss = float(got.mean(axis=0).sum())
    if against_jax:
        with jax.disable_jit():
            xla = float(jax_ssim(jnp.asarray(x), jnp.asarray(y),
                                 use_pallas=False))
            pallas = float(jax_kernel._ssim_pallas_fwd_impl(
                jnp.asarray(x), jnp.asarray(y)))
        assert abs(loss - xla) <= 1e-6
        assert abs(loss - pallas) <= 1e-6
    # per plane against the port's plain version, which the card holds the
    # kernel against
    plain = tk.ssim_planes_plain(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-6)


def test_emulated_plans_differ_only_in_the_order_of_summation():
    x, y = _pair((2, 20, 30, 3), seed=12)
    base = emulate(x, y, tk.ssim_plan(2, 20, 30, 3, torch.float32))
    for kw in ({"k": 2}, {"k": 7, "tile": 12}, {"tile": 27, "stages": 5}):
        other = emulate(x, y, tk.ssim_plan(2, 20, 30, 3, torch.float32, **kw))
        np.testing.assert_allclose(other, base, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"k": 3, "tile": 9}],
                         ids=["own", "cut"])
def test_emulated_x_against_itself_is_exactly_zero(kw):
    x, _ = _pair((2, 14, 17, 3), seed=13)
    for a in (x, _bf16(x)):
        plan = tk.ssim_plan(2, 14, 17, 3, torch.float32, **kw)
        assert float(np.abs(emulate(a, a.copy(), plan)).max()) == 0.0
    assert math.isfinite(float(emulate(x, x * 0, plan).max()))
