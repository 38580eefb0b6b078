"""x2 upsampling of NHWC tensors for GridNet's UpSamplingBlock.

``upsample2x_bilinear_align`` is torch ``nn.Upsample(scale_factor=2,
mode="bilinear", align_corners=True)`` (the reference's up blocks), the
function the JAX package computes in ``ops/resize.py`` as a banded stencil.
``upsample2x_nearest`` repeats every pixel 2x2, the rollout's opt-in
``upsample="nearest"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_bilinear_align(x: torch.Tensor) -> torch.Tensor:
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample2x(x: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    if mode == "bilinear":
        return upsample2x_bilinear_align(x)
    if mode == "nearest":
        return upsample2x_nearest(x)
    raise ValueError(f"upsample must be 'bilinear' or 'nearest', got {mode!r}")
