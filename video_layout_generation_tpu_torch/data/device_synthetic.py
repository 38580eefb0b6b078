"""Synthetic training data rendered on the device (the JAX package's
``data/device_synthetic.py``).

A synthetic sample's whole generative state is 7 floats a rectangle
(``SyntheticTriplets.scene_table``), so the table goes to the card once and
batches are rendered there: an epoch's shuffled indices go up in one copy
when the loader's iteration starts, and each step renders its batch from
its slice of them, so no step waits for the host or copies anything.

The geometry follows ``SyntheticTriplets._render``: truncating casts and
the same clipping, rectangles as interval masks over row and column
indices composited in painter's order, the colour table indexed by the
layout and shaded by row. The host computes rectangle edges in float64 and
the device in float32, so an edge whose exact position rounds differently
can move by one pixel in rare cases: the renderers agree up to a bounded
share of pixels (under 1e-4, ``tests/test_torch_device_data.py``), not bit
for bit. Frames come out as f32 in [0, 1], not quantized to uint8 as the
host pipeline's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.colorize import CITYSCAPES_COLORS


def _render_frames(rows: torch.Tensor, ts: torch.Tensor, hw: Tuple[int, int],
                   colors: torch.Tensor):
    """Render samples at frame times ``ts`` -> (imgs (B,T,H,W,3) f32, segs
    (B,T,H,W) int32). rows: (B, n_shapes, 7) f32 table rows; ts: (T,)
    int; colors: (n_classes, 3) f32 in [0, 1]."""
    h, w = hw
    dev = rows.device
    iy = torch.arange(h, device=dev, dtype=torch.int32)[:, None]
    ix = torch.arange(w, device=dev, dtype=torch.int32)[None, :]
    t = ts.to(torch.float32)[None, :]                          # (1, T)
    seg = torch.zeros((rows.shape[0], ts.shape[0], h, w), dtype=torch.int32,
                      device=dev)

    def edges(c, half, size):
        # int() truncates toward zero, as the host's; values go negative
        # only past the clip floor, so truncate-then-clip is the host math
        lo = ((c - half) * size).to(torch.int32).clamp(0, size)
        hi = ((c + half) * size).to(torch.int32).clamp(0, size)
        return lo[..., None, None], hi[..., None, None]        # (B,T,1,1)

    for i in range(rows.shape[1]):               # painter's order
        cls, cy, cx, hh, ww, vy, vx = (rows[:, i, j, None] for j in range(7))
        y0, y1 = edges(cy + vy * t, hh / 2, h)
        x0, x1 = edges(cx + vx * t, ww / 2, w)
        mask = (iy >= y0) & (iy < y1) & (ix >= x0) & (ix < x1)
        seg = torch.where(mask, cls.to(torch.int32)[..., None, None], seg)
    shade = 0.7 + 0.3 * (torch.arange(h, dtype=torch.float32, device=dev)
                         / (h - 1))[:, None, None]
    img = (colors[seg] * shade).clamp(0.0, 1.0)
    return img, seg


def make_device_renderer(table: np.ndarray, hw: Tuple[int, int],
                         n_classes: int = 20, stride: int = 3,
                         n_frames: int = 3, device="cuda"):
    """Build ``render(idx (B,) int tensor on device) -> batch dict``: the
    triplet contract for ``n_frames == 3``, the stacked window contract
    {"imgs", "segs"} otherwise. The scene table goes to ``device`` here,
    once."""
    device = torch.device(device)
    table_dev = torch.as_tensor(table, dtype=torch.float32).to(device)
    ts = torch.arange(n_frames, dtype=torch.int32, device=device) * stride
    colors = torch.as_tensor(
        CITYSCAPES_COLORS[np.arange(n_classes) % len(CITYSCAPES_COLORS)],
        dtype=torch.float32).to(device) / 255.0
    hw = tuple(hw)

    def render(idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        imgs, segs = _render_frames(table_dev[idx.long()], ts, hw, colors)
        if n_frames != 3:
            return {"imgs": imgs, "segs": segs}
        return {"img1": imgs[:, 0], "img2": imgs[:, 1], "img3": imgs[:, 2],
                "seg1": segs[:, 0].float()[..., None],
                "seg2": segs[:, 1].float()[..., None],
                "seg3": segs[:, 2].long()}

    return render


class DeviceSyntheticLoader:
    """Train-loader drop-in (``set_epoch``, ``len``, ``iter``) whose batches
    are rendered on ``device``: an iteration copies the epoch's indices to
    the device once (from pinned memory on a CUDA device, without waiting)
    and renders each batch from its slice. Shuffles per epoch with the
    host loader's key ``(seed << 16) ^ epoch`` and drops the ragged last
    batch."""

    def __init__(self, dataset, batch_size: int, device="cuda",
                 seed: int = 0, n_frames: int = 3, shuffle: bool = True,
                 drop_last: bool = True):
        self.size = len(dataset)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.device = torch.device(device)
        self.render = make_device_renderer(
            dataset.scene_table(), dataset.hw, dataset.n_classes,
            dataset.stride, n_frames, self.device)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.size // self.batch_size
        return -(-self.size // self.batch_size)

    def _order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng((self.seed << 16) ^ self.epoch)
            order = rng.permutation(self.size)
        else:
            order = np.arange(self.size)
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        return order.astype(np.int32)

    def epoch_indices(self) -> np.ndarray:
        """(n_steps, B) shuffled indices of the current epoch's whole
        batches, in the order iterating the loader renders them (the JAX
        package's epoch executor uploads this array)."""
        order = self._order()
        n = (len(order) // self.batch_size) * self.batch_size
        return order[:n].reshape(-1, self.batch_size)

    def __iter__(self):
        order = torch.from_numpy(self._order())
        if self.device.type == "cuda":
            order = order.pin_memory()
        order = order.to(self.device, non_blocking=True)  # the epoch's copy
        for s in range(0, len(order), self.batch_size):
            yield self.render(order[s:s + self.batch_size])
