"""SSIM-based structural loss (the JAX package's ``losses/ssim.py``).

Per channel: 3x3 stride-1 VALID average-pool window statistics, the SSIM
map, ``(1 - SSIM) / 2`` clamped to [0, 1] and averaged over the map, then
summed over channels. Everything is f32 whatever the input dtype.
"""

from __future__ import annotations

import torch

from ..ops.kernels import ssim as _kernel


def ssim_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y (N, H, W, C) -> scalar: sum over C of the mean (1 - SSIM) / 2.

    Where nothing is differentiated (autograd off, or neither input
    requiring grad: the validation step) the fused path
    (``ops/kernels/ssim.py``): for CUDA tensors one kernel launch, which
    streams each image's rows through a thread-block cluster once and
    merges its sums in the cluster. Its backward re-runs the plain
    formula, so a differentiated call (the train steps) takes the plain
    formula under ordinary autograd instead."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _kernel.ssim_planes_plain(x, y).mean(dim=0).sum()
    return _kernel.ssim_loss(x, y)
