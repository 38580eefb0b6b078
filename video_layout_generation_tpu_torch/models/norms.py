"""Normalization layers of the pix2pix nets (the JAX package's
``models/norms.py``), on NHWC activations.

- ``instance``: per sample and channel over H, W, no affine parameters, no
  running statistics. Every call goes through ``ops/kernels/instance_norm``:
  the hand-written CUDA kernels for a CUDA tensor (forward and backward),
  the plain version for a CPU tensor or under ``ops.kernels.plain()``.
- ``batch``: affine BatchNorm with running statistics as the JAX package's
  ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: parameters ``scale`` and
  ``bias``, buffers ``mean`` and ``var``; in train mode the batch statistics
  normalize and the running ones move by 0.1 towards them (the biased batch
  variance, as flax keeps it).
- ``none``: identity.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.kernels.instance_norm import EPS, instance_norm


class InstanceNorm(nn.Module):
    """Non-affine InstanceNorm over H, W of NHWC."""

    def __init__(self, channels: int = 0, epsilon: float = EPS):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        return instance_norm(x, self.epsilon)


class BatchNorm(nn.Module):
    """Affine BatchNorm over N, H, W of NHWC, statistics in f32."""

    def __init__(self, channels: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """``train`` normalizes with the batch statistics and, unless
        ``update_stats`` is off, moves the running ones (in place)."""
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 1, 2))
            var = (xf * xf).mean(dim=(0, 1, 2)) - mean * mean
            var = var.clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    self.mean.lerp_(mean, self.momentum)
                    self.var.lerp_(var, self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Identity(nn.Module):
    def __init__(self, channels: int = 0):
        super().__init__()

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        return x


def get_norm_layer(norm_type: str = "instance") -> Callable[[int], nn.Module]:
    """``norm_layer(channels) -> module`` whose forward takes ``(x, train,
    update_stats)``."""
    if norm_type == "instance":
        return InstanceNorm
    if norm_type == "batch":
        return BatchNorm
    if norm_type == "none":
        return Identity
    raise NotImplementedError(
        f"normalization layer [{norm_type}] is not found")


def norm_name(norm_type: str) -> str:
    """The flax auto-name stem of the layer (``BatchNorm_0``, ...)."""
    return get_norm_layer(norm_type).__name__


def norm_uses_bias(norm_type: str) -> bool:
    """Convs followed by BatchNorm skip their bias."""
    return norm_type != "batch"
