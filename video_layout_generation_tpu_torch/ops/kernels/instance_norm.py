"""Non-affine InstanceNorm over H, W of an NHWC tensor, forward and backward.

``instance_norm`` launches ``csrc/instance_norm.cu`` for a CUDA tensor and
runs ``instance_norm_plain`` for a CPU tensor or under ``plain()``. It is
the counterpart of the TPU kernels of ``ops/pallas/instance_norm.py`` of the
JAX package:

- ``_pallas_fwd``: the differentiated forward, which keeps what the backward
  needs. Here ``y`` is ``xhat`` (no affine), so one tensor is written and
  saved, plus ``rstd`` (N, C) f32;
- ``_pallas_fwd_only``: the forward that keeps nothing, taken when no input
  requires grad or autograd is off;
- ``_pallas_bwd``: ``dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat))``.

Mean and biased variance per (n, c) plane, f32 statistics whatever the
input dtype (f32 or bf16), eps 1e-5. Unlike the TPU kernel, which takes
only lane-aligned channel counts and planes that fit on chip, the CUDA
kernel takes any N, H, W, C: no shape-dependent switch to the plain version
exists.

Each call is one launch. ``instance_norm_plan`` decides on the host how it
runs: each (n, channel tile) slice of the image goes to one thread-block
cluster of up to 16 CTAs that holds the slice in shared memory (the
"resident" regime: the input is read from device memory once), or, for a
slice that no cluster holds, part of it (the "streaming" regime). The call
allocates its outputs and nothing else.

The backward kernel runs through a second ``torch.autograd.Function`` whose
own backward is the closed form in torch ops, so a gradient of a gradient
(the WGAN-GP penalty) works on the card too.

Three counters tell the launches apart: ``instance_norm.launches_fwd``,
``instance_norm.launches_fwd_only`` and ``instance_norm.launches_bwd``.
"""

from __future__ import annotations

import functools

import torch

from . import _checks
from ._build import library
from ._checks import (check_cuda, data_ptr, raise_on_error, sm_count,
                      stream_ptr)

EPS = 1e-5

# The kernel's fixed geometry (csrc/instance_norm.cu).
NTHREADS = 256
NWARPS = NTHREADS // 32
MAX_LANES = 32              # 16-byte channel vectors of a tile
MAX_CLUSTER = 16            # CTAs of a cluster; more than 8 is non-portable
PORTABLE_CLUSTER = 8
SMEM_MAX = 232448           # shared memory of one block on an H100
# The plan's choices, in order of preference, as measured on an H100 by
# tools/check_instance_norm.py --sweep (PERF.md): a tile's row segment
# (16-byte rows take twice as long), then the rows one CTA holds.
ROW_BYTES = (128, 64, 32)
CTA_BYTES = (64 * 1024, 128 * 1024)
STREAM_BYTES = 24 * 1024    # rows one CTA of a streaming plan holds
MIN_ROWS_PER_THREAD = 4     # a small image is not spread thinner than this
N_SM = 132                  # an H100; the wrapper passes the card's own


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype in (torch.float32, torch.float64) \
        else torch.float32


def instance_norm_plain(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version: (x - mean) * rsqrt(var + eps) per (n, c) plane
    of NHWC ``x``, biased variance, statistics in f32 (f64 for an f64
    input), result in ``x``'s dtype."""
    return _forward_plain(x, eps)[0]


def _forward_plain(x: torch.Tensor, eps: float):
    """(y in x's dtype, rstd (N, C) in the statistics' dtype)."""
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=(1, 2), keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xc * rstd).to(x.dtype), rstd[:, 0, 0, :]


def instance_norm_bwd_plain(dy: torch.Tensor, xhat: torch.Tensor,
                            rstd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: dy, xhat (N, H, W, C), rstd
    (N, C) -> dx in dy's dtype, means over H, W in the statistics' dtype."""
    st = _stat_dtype(dy)
    g, xh = dy.to(st), xhat.to(st)
    m_dy = g.mean(dim=(1, 2), keepdim=True)
    m_dyx = (g * xh).mean(dim=(1, 2), keepdim=True)
    dx = rstd.to(st)[:, None, None, :] * (g - m_dy - xh * m_dyx)
    return dx.to(dy.dtype)


def _check_nhwc(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name} must be NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16 on a CUDA "
                         f"device, got {x.dtype}")


def smem_bytes(ct: int, held: int, esize: int, bufs: int) -> int:
    """Shared memory of one CTA: NWARPS * ct floats for the CTA's sums, 4 *
    ct of statistics, then ``bufs`` tensors of ``held`` rows of ``ct``
    values."""
    return 4 * (NWARPS + 4) * ct + held * ct * esize * bufs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def instance_norm_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
                       backward: bool = False, n_sm: int = N_SM) -> dict:
    """How one call on an (n, h, w, c) tensor of ``dtype`` runs: channel
    tiles of ``ct`` channels (``vec`` a 16-byte vector, or 1 for a ragged
    C), one cluster of ``k`` CTAs for each (n, tile) slice, ``rows`` pixels a
    CTA (the last one fewer) of which it holds ``held`` in ``smem`` bytes of
    shared memory; the grid is (k, ctiles, n). ``regime`` is "resident"
    where every row is held, else "streaming". The backward holds dy and y.

    Resident: the first of (CTAs of ``CTA_BYTES``) x (row segments of
    ``ROW_BYTES``, a whole row where C is narrower) whose slice fits a
    cluster of 16; a small image then takes more CTAs a slice until the
    card is full. Streaming where none fits: whole rows (up to 32 vectors),
    clusters of 16 CTAs that hold ``STREAM_BYTES`` each. The dict is kept
    per shape: read it, do not change it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"InstanceNorm takes float32 or bfloat16, got {dtype}")
    if min(n, h, w, c) < 1:
        raise ValueError(f"empty InstanceNorm: {(n, h, w, c)}")
    hw = h * w
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // esize if c % (16 // esize) == 0 else 1
    bufs = 2 if backward else 1
    lanes = 1
    while lanes < min(MAX_LANES, _cdiv(c, vec)):
        lanes *= 2
    whole = lanes * vec          # the narrowest tile that covers C

    def slice_bytes(ct):
        return hw * ct * esize * bufs

    for per_cta in CTA_BYTES:
        fits = [ct for ct in (min(whole, max(vec, b // esize))
                              for b in ROW_BYTES)
                if _cdiv(slice_bytes(ct), per_cta) <= MAX_CLUSTER]
        if fits:
            ct, regime = fits[0], "resident"
            k = _cdiv(slice_bytes(ct), per_cta)
            break
    else:
        ct, k, regime = whole, MAX_CLUSTER, "streaming"
    ctiles = _cdiv(c, ct)
    ty_n = NTHREADS // (ct // vec)
    cap = PORTABLE_CLUSTER if k <= PORTABLE_CLUSTER else MAX_CLUSTER
    k = max(k, min(cap, _cdiv(n_sm, n * ctiles),
                   hw // (MIN_ROWS_PER_THREAD * ty_n)))
    rows = _cdiv(hw, k)
    k = _cdiv(hw, rows)          # every CTA holds one row or more
    row = ct * esize * bufs
    held = rows if regime == "resident" else min(rows - 1,
                                                  STREAM_BYTES // row)
    return dict(regime=regime, vec=vec, ct=ct, ctiles=ctiles, k=k,
                rows=rows, held=held, smem=smem_bytes(ct, held, esize, bufs))


def _plan_args(plan: dict) -> tuple:
    return plan["ct"], plan["k"], plan["rows"], plan["held"], plan["smem"]


def active_clusters(x: torch.Tensor, backward: bool = False) -> int:
    """How many clusters of ``x``'s plan the card holds at once
    (``cudaOccupancyMaxActiveClusters``). Raises where that is none."""
    n, h, w, c = x.shape
    plan = instance_norm_plan(n, h, w, c, x.dtype, backward,
                              sm_count(x.device))
    count = library("instance_norm").vlg_instance_norm_active_clusters(
        n, h * w, c, int(x.dtype == torch.bfloat16), int(backward),
        *_plan_args(plan))
    if count <= 0:
        raise RuntimeError(f"instance_norm: the card runs no cluster of the "
                           f"plan {plan} (result {count})")
    return count


def _launch_fwd(x: torch.Tensor, eps: float, keep: bool):
    """Launch the forward on a CUDA tensor. ``keep`` also returns rstd
    (N, C) f32 (else None). Raises on anything the kernel does not take."""
    _check_nhwc(x, "x")
    n, h, w, c = x.shape
    check_cuda(x, x.dtype, (n, h, w, c), "x")
    plan = instance_norm_plan(n, h, w, c, x.dtype, False, sm_count(x.device))
    y = torch.empty_like(x)
    rstd = (torch.empty((n, c), dtype=torch.float32, device=x.device)
            if keep else None)
    err = library("instance_norm").vlg_instance_norm_fwd(
        data_ptr(x), data_ptr(y), data_ptr(rstd), n, h * w, c, float(eps),
        int(x.dtype == torch.bfloat16), *_plan_args(plan),
        stream_ptr(x.device))
    raise_on_error(err, "instance_norm")
    if keep:
        instance_norm.launches_fwd += 1
    else:
        instance_norm.launches_fwd_only += 1
    return y, rstd


def _launch_bwd(dy: torch.Tensor, xhat: torch.Tensor,
                rstd: torch.Tensor) -> torch.Tensor:
    _check_nhwc(dy, "dy")
    n, h, w, c = dy.shape
    check_cuda(dy, dy.dtype, (n, h, w, c), "dy")
    check_cuda(xhat, dy.dtype, (n, h, w, c), "xhat", dy.device)
    check_cuda(rstd, torch.float32, (n, c), "rstd", dy.device)
    plan = instance_norm_plan(n, h, w, c, dy.dtype, True, sm_count(dy.device))
    dx = torch.empty_like(dy)
    err = library("instance_norm").vlg_instance_norm_bwd(
        data_ptr(dy), data_ptr(xhat), data_ptr(rstd), data_ptr(dx), n, h * w,
        c, int(dy.dtype == torch.bfloat16), *_plan_args(plan),
        stream_ptr(dy.device))
    raise_on_error(err, "instance_norm backward")
    instance_norm.launches_bwd += 1
    return dx


class _InstanceNormBackward(torch.autograd.Function):
    """dx from (dy, xhat, rstd): the backward kernel (its plain version for
    CPU tensors). Its own backward is autograd of the plain closed form, so
    the first derivative can be differentiated again."""

    @staticmethod
    def forward(ctx, dy, xhat, rstd):
        ctx.save_for_backward(dy, xhat, rstd)
        if dy.device.type == "cpu":
            return instance_norm_bwd_plain(dy, xhat, rstd)
        return _launch_bwd(dy, xhat, rstd)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            out = instance_norm_bwd_plain(*leaves)
            return torch.autograd.grad(out, leaves, grad.to(out.dtype))


class InstanceNormFunction(torch.autograd.Function):
    """(y, rstd) from x. Forward: the kernel that keeps y and rstd. Backward:
    the backward kernel through ``_InstanceNormBackward``. ``rstd`` is an
    output so that a second derivative sees its dependence on x; first-order
    use hands it no gradient."""

    @staticmethod
    def forward(ctx, x, eps):
        if x.device.type == "cpu":
            y, rstd = _forward_plain(x, eps)
        else:
            y, rstd = _launch_fwd(x, eps, keep=True)
        ctx.save_for_backward(y, rstd)
        ctx.set_materialize_grads(False)
        return y, rstd

    @staticmethod
    def backward(ctx, dy, drstd):
        y, rstd = ctx.saved_tensors
        dx = None
        if dy is not None:
            dx = _InstanceNormBackward.apply(dy.contiguous(), y, rstd)
        if drstd is not None:
            # d rstd / d x = -rstd^3 (x - mean) / HW = -rstd^2 xhat / HW
            hw = y.shape[1] * y.shape[2]
            st = rstd.dtype
            extra = (-(drstd.to(st) * rstd * rstd)[:, None, None, :]
                     * y.to(st) / hw).to(y.dtype)
            dx = extra if dx is None else dx + extra
        return dx, None


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Non-affine InstanceNorm of NHWC ``x`` (f32 or bf16) over H and W.

    A CPU tensor, or any tensor under ``plain()``, runs the plain version
    (under ``plain()`` in ordinary autograd); a CUDA tensor launches the
    kernel, and anything the kernel does not take (another dtype, a tensor
    that is not contiguous) raises. With autograd on and ``x`` requiring
    grad the forward keeps y and rstd for the backward kernel; otherwise
    the forward keeps nothing."""
    if _checks.PLAIN:
        return instance_norm_plain(x, eps)
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormFunction.apply(x, eps)[0]
    if x.device.type == "cpu":
        return instance_norm_plain(x, eps)
    return _launch_fwd(x, eps, keep=False)[0]


instance_norm.launches_fwd = 0
instance_norm.launches_fwd_only = 0
instance_norm.launches_bwd = 0
