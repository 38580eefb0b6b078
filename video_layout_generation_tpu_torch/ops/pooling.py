"""Window reductions on NHWC tensors (the JAX package's ``ops/pooling.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_hw(x: torch.Tensor, fn) -> torch.Tensor:
    """Apply an NCHW pooling function over the H, W axes of ...HWC."""
    lead = x.shape[:-3]
    y = fn(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def avg_pool_3x3_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID average pool over the H, W axes of ...HWC, summed
    in f32 and returned in ``x``'s dtype (torch ``F.avg_pool2d(x, 3, 1)``)."""
    return _pool_hw(x.float(), lambda t: F.avg_pool2d(t, 3, 1)).to(x.dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over the H, W axes of ...HWC (torch
    ``nn.MaxPool2d(2, 2)``; an odd trailing row or column is dropped)."""
    return _pool_hw(x, lambda t: F.max_pool2d(t, 2, 2)).contiguous()
