"""Weight initializers of the pix2pix nets (the JAX package's
``models/init.py``): normal | xavier | kaiming | orthogonal with the
``init_gain`` scaling, for kernels in flax's layout (..., fan-in axis,
fan-out axis), drawn from an explicit ``torch.Generator``.

The numbers differ from JAX's for the same seed; the distributions are the
same, and parity runs carry the weights across through the bridge."""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _fans(shape: Sequence[int]):
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _orthogonal(shape, gain: float, generator) -> torch.Tensor:
    """Rows or columns (whichever are fewer) of the (prod(shape[:-1]),
    shape[-1]) matrix are orthonormal, times ``gain``."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.randn(max(n_rows, n_cols), min(n_rows, n_cols),
                    generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.t()
    return gain * q.reshape(tuple(shape))


def get_initializer(init_type: str = "normal", init_gain: float = 0.02
                    ) -> Callable:
    """``init(shape, generator) -> f32 tensor``."""
    if init_type == "normal":
        return lambda shape, generator: init_gain * torch.randn(
            tuple(shape), generator=generator)
    if init_type == "xavier":
        # variance gain^2 / fan_avg (torch xavier_normal_ with gain)
        return lambda shape, generator: init_gain * math.sqrt(
            2.0 / sum(_fans(shape))) * torch.randn(tuple(shape),
                                                   generator=generator)
    if init_type == "kaiming":
        # He normal (torch kaiming_normal_(a=0, mode='fan_in'))
        return lambda shape, generator: math.sqrt(
            2.0 / _fans(shape)[0]) * torch.randn(tuple(shape),
                                                 generator=generator)
    if init_type == "orthogonal":
        return lambda shape, generator: _orthogonal(shape, init_gain,
                                                    generator)
    raise NotImplementedError(
        f"initialization method [{init_type}] is not implemented")
