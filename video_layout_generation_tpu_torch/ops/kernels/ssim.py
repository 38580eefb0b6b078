"""Fused SSIM loss: one pass over two NHWC images to per-plane means.

``ssim_planes`` / ``ssim_loss`` launch ``csrc/ssim.cu`` for CUDA tensors
and run ``ssim_planes_plain`` for CPU tensors. They are the counterpart of
the TPU kernel ``ops/pallas/ssim.py:_ssim_pallas_fwd_impl``
(ssim_loss_pallas) of the JAX package: per (n, c) plane the 3x3 VALID
window means of x, y, x^2, y^2 and xy, the SSIM map with C1 = 0.01^2 and
C2 = 0.03^2, clip((1 - SSIM) / 2, 0, 1) and the plane mean, in f32;
``ssim_loss`` is the sum over channels of the mean over the batch.

Unlike the TPU kernel, which holds a whole plane on chip, the CUDA kernel
tiles the plane, so there is no plane-size limit and no size-dependent
switch to the plain version.

As in the JAX package (a custom VJP around a forward-only kernel), the
gradient is autograd of the plain formula on the saved inputs.
"""

from __future__ import annotations

import torch

from ..pooling import avg_pool_3x3_valid
from ._build import library
from ._checks import check_cuda, data_ptr, raise_on_error, stream_ptr

C1 = 0.01 ** 2
C2 = 0.03 ** 2


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


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Check the arguments and launch the kernel; raises on anything it
    does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    check_cuda(x, x.dtype, (n, h, w, c), "x")
    check_cuda(y, x.dtype, (n, h, w, c), "y", x.device)
    lib = library("ssim")
    smem = lib.vlg_ssim_smem(c)
    if smem > 227 * 1024:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory per "
                         f"block; the card has 227 KB")
    partial = torch.empty(lib.vlg_ssim_partials(n, h, w, c),
                          dtype=torch.float32, device=x.device)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    err = lib.vlg_ssim_planes(
        data_ptr(x), data_ptr(y), data_ptr(partial), data_ptr(out),
        n, h, w, c, int(x.dtype == torch.bfloat16), stream_ptr(x.device))
    raise_on_error(err, "ssim_loss")
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

    CPU tensors run the plain version; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    _check_pair(x, y)
    return _SsimPlanes.apply(x, y)


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scalar f32: sum over channels of the batch mean of ``ssim_planes``."""
    return ssim_planes(x, y).mean(dim=0).sum()


ssim_loss.launches = 0
