"""One-hot encoding of segmentation id maps (the JAX package's
``ops/one_hot.py``): (..., H, W) integer ids -> (..., H, W, n_cls)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def seg_one_hot(seg: torch.Tensor, n_cls: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Ids outside [0, n_cls) give an all-zero row, as ``jax.nn.one_hot``
    does."""
    ids = torch.as_tensor(seg).long()
    valid = (ids >= 0) & (ids < n_cls)
    out = F.one_hot(torch.where(valid, ids, 0), n_cls).to(dtype)
    return out * valid.unsqueeze(-1).to(dtype)
