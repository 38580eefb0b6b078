"""Pixel-space losses in f32 (the JAX package's ``losses/pixel.py``).

- ``l1_loss``: mean absolute error.
- ``gradient_loss``: L1 between the absolute finite-difference maps of
  output and target along H and W of an NHWC tensor, normalized by the full
  element count of the input (not of the difference maps).
"""

from __future__ import annotations

import torch


def l1_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (output.float() - target.float()).abs().mean()


def gradient_loss(output: torch.Tensor, target: torch.Tensor
                  ) -> torch.Tensor:
    a, b = output.float(), target.float()

    def d(dim, x):
        n = x.shape[dim]
        return (x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)).abs()

    xloss = (d(-3, a) - d(-3, b)).abs().sum()
    yloss = (d(-2, a) - d(-2, b)).abs().sum()
    return (xloss + yloss) / a.numel()
