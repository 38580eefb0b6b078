"""Fused SSIM loss: one pass over two NHWC images to per-plane means.

``ssim_planes`` / ``ssim_loss`` launch ``csrc/ssim.cu`` for CUDA tensors and
run ``ssim_planes_plain`` for CPU tensors or under ``plain()``. They are the
counterpart of the TPU kernel ``ops/pallas/ssim.py:_ssim_pallas_fwd_impl``
(ssim_loss_pallas) of the JAX package: per (n, c) plane the 3x3 VALID window
means of x, y, x^2, y^2 and xy, the SSIM map with C1 = 0.01^2 and C2 =
0.03^2, clip((1 - SSIM) / 2, 0, 1) and the plane mean, in f32; ``ssim_loss``
is the sum over channels of the mean over the batch.

Each call is one launch, and allocates its (N, C) output and nothing else.
``ssim_plan`` decides on the host how it runs: one thread-block cluster of
``k`` CTAs per image, each CTA ``rows`` output rows (and the 2 rows of the
window below them) and every column; a producer warp streams the rows with
bulk copies through a ring of ``stages`` slots in shared memory while the
consumer warps compute; the cluster merges its CTAs' channel sums through
distributed shared memory in rank order. Unlike the TPU kernel, which holds
a whole plane on chip, the CUDA kernel takes any N, any H, W >= 3 and any C
up to ``MAX_C``: there is no size-dependent switch to the plain version.

As in the JAX package (a custom VJP around a forward-only kernel), the
gradient is autograd of the plain formula on the saved inputs.
"""

from __future__ import annotations

import functools
import math

import torch

from ..pooling import avg_pool_3x3_valid
from . import _checks
from ._build import library
from ._checks import check_cuda, data_ptr, stream_ptr

C1 = 0.01 ** 2
C2 = 0.03 ** 2

# The kernel's fixed geometry (csrc/ssim.cu).
MAX_CLUSTER = 16        # CTAs of a cluster; more than 8 is non-portable
MIN_STAGES = 3          # a consumer step holds 3 ring slots
MAX_STAGES = 64
SMEM_MAX = 232448       # shared memory of one block on an H100
ONE_PER_SM = 118784     # a CTA with this much shared memory holds an SM
COLS = 4                # flat columns a consumer thread owns
MAX_THREADS = 256       # consumer threads a CTA may have
MAX_C = MAX_THREADS * COLS   # a pass holds one column of every channel
# The plan's choice of K (PERF.md, tools/check_ssim.py --sweep).
FIXED_ROWS = 4           # a CTA's start and end, in the time of its rows
N_SM = 132               # an H100, for a plan made without the card


def ssim_planes_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, H, W, C) x 2 -> (N, C) f32 plane means of
    clip((1 - SSIM) / 2, 0, 1). The five window statistics are stacked
    along the channels and pooled in one pass."""
    xf, yf = x.float(), y.float()
    stats = torch.cat([xf, yf, xf * xf, yf * yf, xf * yf], dim=-1)
    mu_x, mu_y, xx, yy, xy = avg_pool_3x3_valid(stats).chunk(5, dim=-1)
    sigma_x = xx - mu_x * mu_x
    sigma_y = yy - mu_y * mu_y
    sigma_xy = xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    val = ((1.0 - num / den) / 2.0).clamp(0.0, 1.0)
    return val.mean(dim=(1, 2))


def _check_pair(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape != y.shape:
        raise ValueError(f"x and y must be NHWC of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise ValueError(f"x and y must share a dtype, got {x.dtype} and "
                         f"{y.dtype}")
    if x.shape[1] < 3 or x.shape[2] < 3:
        raise ValueError(f"SSIM needs H, W >= 3, got {tuple(x.shape)}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slot_bytes(tile: int, c: int, esize: int) -> int:
    """Bytes of one tensor's segment in a ring slot: ``tile + 2c`` values
    from the 16-byte boundary below the first one."""
    return _cdiv((tile + 2 * c) * esize + 15, 16) * 16


def smem_bytes(stages: int, tile: int, c: int, esize: int,
               parts: int) -> int:
    """Shared memory of one CTA: 2 mbarriers a slot, the ring (x and y a
    slot), ``tile`` column sums, ``parts * c`` partial sums, ``c`` channel
    sums."""
    return (16 * stages + 2 * stages * slot_bytes(tile, c, esize)
            + 4 * (tile + parts * c + c))


def _capacity_model() -> tuple:
    """Clusters of k = 1..16 CTAs that run at once on ``N_SM`` SMs, one
    CTA an SM, as if every SM could join any cluster; the card's own counts
    (``cluster_capacity``) are lower where its GPCs leave SMs over."""
    return tuple(N_SM // k for k in range(1, MAX_CLUSTER + 1))


@functools.lru_cache(maxsize=None)
def ssim_plan(n: int, h: int, w: int, c: int, dtype: torch.dtype,
              capacity: tuple = None, k: int = None, stages: int = None,
              tile: int = None) -> dict:
    """How one call on (n, h, w, c) images of ``dtype`` runs. ``capacity``
    holds the clusters of 1..16 CTAs the card runs at once
    (``cluster_capacity``; without it, ``N_SM // k``). The keywords after
    it replace the plan's own choices (the sweep and the tests use them).

    - ``k`` CTAs a cluster, one cluster an image, ``rows`` output rows a
      CTA (the last one fewer, each CTA one or more): the k whose clusters
      finish first, counting the waves of clusters the card runs and each
      CTA's rows plus its 2 halo rows and ``FIXED_ROWS``;
    - ``tile`` flat output columns a pass (a multiple of C; the whole row
      where it fits, else a multiple of C and of a 16-byte vector, so that
      passes start on 16 bytes), ``tiles`` passes, ``threads`` consumer
      threads of ``COLS`` columns each (a multiple of 32);
    - ``stages`` ring slots: as many as fill ``ONE_PER_SM`` bytes, so that
      one CTA holds an SM, within ``MIN_STAGES`` and ``MAX_STAGES``;
    - ``group``: column groups (C columns each) a thread sums in the
      per-channel reduction, about the square root of the groups;
    - ``align``: the bytes to which every streamed segment starts and ends
      (16: bulk copies alone; less: the values outside 16-byte boundaries go
      value by value);
    - ``smem`` bytes of shared memory a CTA.

    The dict is kept per shape: read it, do not change it."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"SSIM takes float32 or bfloat16, got {dtype}")
    if n < 1 or h < 3 or w < 3 or c < 1:
        raise ValueError(f"SSIM needs N, C >= 1 and H, W >= 3, got "
                         f"{(n, h, w, c)}")
    esize = 2 if dtype == torch.bfloat16 else 4
    out_rows, out_cols, row_len = h - 2, (w - 2) * c, w * c
    if k is None:
        cap = capacity or _capacity_model()

        def cost(kk):
            rows = _cdiv(out_rows, kk)
            return _cdiv(n, max(cap[kk - 1], 1)) * (rows + 2 + FIXED_ROWS)
        k = min(range(1, min(MAX_CLUSTER, out_rows) + 1),
                key=lambda kk: (cost(kk), -kk))
    if not 1 <= k <= MAX_CLUSTER:
        raise ValueError(f"cluster of {k} CTAs; the card takes 1 to "
                         f"{MAX_CLUSTER}")
    rows = _cdiv(out_rows, min(k, out_rows))
    k = _cdiv(out_rows, rows)          # every CTA owns one row or more
    if c > MAX_C:
        raise ValueError(f"C={c} is wider than one pass; the kernel takes "
                         f"C <= {MAX_C}")
    if tile is None:
        if out_cols <= MAX_C:
            tile = out_cols
        else:
            unit = c * (16 // esize) // math.gcd(c, 16 // esize)
            unit = unit if unit <= MAX_C else c
            tile = MAX_C // unit * unit
    if tile % c or not c <= tile <= min(out_cols, MAX_C):
        raise ValueError(f"a pass of {tile} columns: it must be a multiple "
                         f"of C={c}, at most {min(out_cols, MAX_C)}")
    tiles = _cdiv(out_cols, tile)
    threads = _cdiv(_cdiv(tile, COLS), 32) * 32
    groups = tile // c
    group = math.isqrt(groups - 1) + 1
    parts = _cdiv(groups, group)
    if stages is None:
        stages = max(MIN_STAGES, min(MAX_STAGES, _cdiv(
            ONE_PER_SM, 2 * slot_bytes(tile, c, esize))))
        while stages > MIN_STAGES and smem_bytes(stages, tile, c, esize,
                                                 parts) > SMEM_MAX:
            stages -= 1
    if not MIN_STAGES <= stages <= MAX_STAGES:
        raise ValueError(f"{stages} ring slots; the kernel takes "
                         f"{MIN_STAGES} to {MAX_STAGES}")
    smem = smem_bytes(stages, tile, c, esize, parts)
    if smem > SMEM_MAX:
        raise ValueError(f"C={c}: a CTA needs {smem} bytes of shared "
                         f"memory; the card has {SMEM_MAX}")
    ends = (tile * esize, (tile + 2 * c) * esize) if tiles > 1 else ()
    align = math.gcd(16, row_len * esize, *ends)
    return dict(k=k, rows=rows, stages=stages, threads=threads,
                tile=tile, tiles=tiles, group=group, parts=parts,
                align=align, smem=smem)


def _plan_args(plan: dict) -> tuple:
    return (plan["k"], plan["rows"], plan["stages"], plan["threads"],
            plan["tile"], plan["group"], plan["smem"])


@functools.lru_cache(maxsize=None)
def cluster_capacity(device: torch.device) -> tuple:
    """Clusters of 1..16 CTAs the card runs at once, one CTA an SM
    (``cudaOccupancyMaxActiveClusters``): what ``ssim_plan`` takes as
    ``capacity``."""
    lib = library("ssim")
    with torch.cuda.device(device):
        counts = tuple(lib.vlg_ssim_cluster_capacity(k)
                       for k in range(1, MAX_CLUSTER + 1))
    if min(counts) < 0:
        raise RuntimeError(f"ssim: cluster capacity query failed: {counts}")
    return counts


def plan_for(x: torch.Tensor) -> dict:
    """The plan of a call on the CUDA tensor ``x``, on its card."""
    n, h, w, c = x.shape
    return ssim_plan(n, h, w, c, x.dtype, cluster_capacity(x.device))


def active_clusters(x: torch.Tensor, plan: dict = None) -> int:
    """How many clusters of ``x``'s plan (or ``plan``) the card holds at
    once (``cudaOccupancyMaxActiveClusters``); 0 or less where it holds
    none."""
    n, h, w, c = x.shape
    plan = plan or plan_for(x)
    return library("ssim").vlg_ssim_active_clusters(
        n, h, w, c, int(x.dtype == torch.bfloat16), *_plan_args(plan))


def _launch(x: torch.Tensor, y: torch.Tensor, plan: dict = None
            ) -> torch.Tensor:
    """Check the arguments and launch the kernel on ``x``'s plan (or
    ``plan``); raises on anything it does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    check_cuda(x, x.dtype, (n, h, w, c), "x")
    check_cuda(y, x.dtype, (n, h, w, c), "y", x.device)
    plan = plan or plan_for(x)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    err = library("ssim").vlg_ssim_planes(
        data_ptr(x), data_ptr(y), data_ptr(out), n, h, w, c,
        int(x.dtype == torch.bfloat16), *_plan_args(plan),
        stream_ptr(x.device))
    if err:
        raise RuntimeError(
            f"ssim_loss: kernel launch failed with CUDA error {err} on the "
            f"plan {plan}; the card holds {active_clusters(x, plan)} of its "
            f"clusters at once")
    ssim_loss.launches += 1
    return out


class _SsimPlanes(torch.autograd.Function):
    """Forward: the kernel (the plain version for CPU tensors). Backward:
    autograd of the plain formula on the saved inputs."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        if x.device.type == "cpu":
            return ssim_planes_plain(x, y)
        return _launch(x, y)

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            yd = y.detach().requires_grad_(True)
            gx, gy = torch.autograd.grad(ssim_planes_plain(xd, yd),
                                         (xd, yd), grad)
        return gx, gy


def ssim_planes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, C) f32 plane means of clip((1 - SSIM) / 2, 0, 1) for NHWC ``x``
    and ``y`` of equal shape and dtype (f32 or bf16).

    CPU tensors, or any tensors under ``plain()``, run the plain version
    (under ``plain()`` in ordinary autograd); CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if _checks.PLAIN:
        return ssim_planes_plain(x, y)
    _check_pair(x, y)
    return _SsimPlanes.apply(x, y)


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar f32: sum over channels of the batch mean of ``ssim_planes``."""
    return ssim_planes(x, y).mean(dim=0).sum()


ssim_loss.launches = 0
