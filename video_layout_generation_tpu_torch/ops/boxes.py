"""Mask -> bounding box (the JAX package's ``ops/boxes.py``): the box
(h1, w1, h2, w2) of the inner (zero) region of each mask whose outer region
is 1, as a min / max over index grids on the mask's device, with no loop
over the batch (the reference's ``mask2box`` loops over it with
``torch.nonzero``)."""

from __future__ import annotations

import torch


def mask2box(mask: torch.Tensor) -> torch.Tensor:
    """mask: (N, H, W), outer region 1. Returns (N, 4) int32
    [h_min, w_min, h_max, w_max] of the inner (mask == 0) region.

    A mask with no inner region gives [H, W, -1, -1] (an empty box)."""
    n, h, w = mask.shape
    inner = mask == 0
    rows = torch.arange(h, dtype=torch.int32, device=mask.device).view(
        1, h, 1).expand(n, h, w)
    cols = torch.arange(w, dtype=torch.int32, device=mask.device).view(
        1, 1, w).expand(n, h, w)
    big = torch.tensor(h + w, dtype=torch.int32, device=mask.device)
    none = torch.tensor(-1, dtype=torch.int32, device=mask.device)
    h_min = torch.where(inner, rows, big).amin(dim=(1, 2)).clamp_max(h)
    w_min = torch.where(inner, cols, big).amin(dim=(1, 2)).clamp_max(w)
    h_max = torch.where(inner, rows, none).amax(dim=(1, 2))
    w_max = torch.where(inner, cols, none).amax(dim=(1, 2))
    return torch.stack([h_min, w_min, h_max, w_max], dim=1)
