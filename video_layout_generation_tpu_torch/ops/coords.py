"""CoordConv coordinate channels (the JAX package's ``ops/coords.py``)."""

from __future__ import annotations

import torch


def coord_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(h, w, 2) normalized coordinate grid in [-1, 1]: channel 0 varies
    along H, channel 1 along W."""
    hh = torch.arange(h, dtype=torch.float32, device=device) / max(h - 1, 1)
    ww = torch.arange(w, dtype=torch.float32, device=device) / max(w - 1, 1)
    hh = (hh * 2 - 1)[:, None].expand(h, w)
    ww = (ww * 2 - 1)[None, :].expand(h, w)
    return torch.stack([hh, ww], dim=-1).to(dtype)


def add_coord_channels(x: torch.Tensor) -> torch.Tensor:
    """Append the two coordinate channels to an NHWC tensor."""
    n, h, w, _ = x.shape
    grid = coord_grid(h, w, x.dtype, x.device)[None].expand(n, h, w, 2)
    return torch.cat([x, grid], dim=-1)
