"""SSIM-based structural loss (the JAX package's ``losses/ssim.py``).

Per channel: 3x3 stride-1 VALID average-pool window statistics, the SSIM
map, ``(1 - SSIM) / 2`` clamped to [0, 1] and averaged over the map, then
summed over channels. Everything is f32 whatever the input dtype.
"""

from __future__ import annotations

import torch

from ..ops.kernels import ssim as _kernel


def ssim_loss(x: torch.Tensor, y: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    """x, y (N, H, W, C) -> scalar: sum over C of the mean (1 - SSIM) / 2.

    ``use_kernel=True`` takes the fused path (``ops/kernels/ssim.py``): for
    CUDA tensors one kernel launch, which streams each image's rows through
    a thread-block cluster once and merges its sums in the cluster; its
    plain version for CPU tensors. Its backward re-runs the plain formula,
    so only paths that are never differentiated ask for it
    (``CombinedLoss.eval_variant``). The default is the plain formula under
    ordinary autograd."""
    if use_kernel:
        return _kernel.ssim_loss(x, y)
    return _kernel.ssim_planes_plain(x, y).mean(dim=0).sum()
