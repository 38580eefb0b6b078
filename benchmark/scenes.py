"""Synthetic scenes from the seed: the benchmark's own copy of the scene
generator of the port's ``data/synthetic.py``, rendered in bulk on the
card.

A scene is ``n_shapes`` rectangles of random classes moving at constant
velocity over a background of a random class; a frame is the layout
(class ids) and its Cityscapes palette colours, shaded along H, with
sensor noise (uniform, ``NOISE`` a channel) on every pixel. Frame k is
sampled at time ``k * stride``. Unlike the port's generator (a class-0
background, no noise), no two scenes share their background and no
region of a frame is uniform: uniform regions give a net the same input
over the region, and a near tie of two classes there flips the whole
region at once. The parameters are drawn with numpy from the seed; the
frames are rendered with torch on ``device``, all scenes of a chunk at
once, and returned as uint8 host arrays (frames exact at 1/255, so a
uint8 transfer loses nothing).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32], [0, 0, 0]], dtype=np.uint8)


NOISE = 0.05


def scene_params(seed: int, n: int, n_classes: int = 20,
                 n_shapes: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n_shapes, 7) [cls, cy, cx, hh, ww, vy, vx] of n scenes and
    their (n,) background classes."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, n_shapes, 7), np.float64)
    out[..., 0] = rng.integers(1, n_classes, (n, n_shapes))
    out[..., 1:3] = rng.uniform(0.15, 0.85, (n, n_shapes, 2))
    out[..., 3:5] = rng.uniform(0.05, 0.25, (n, n_shapes, 2))
    out[..., 5:7] = rng.uniform(-0.01, 0.01, (n, n_shapes, 2))
    return out, rng.integers(0, n_classes, n)


def render(seed: int, n: int, n_frames: int, hw: Tuple[int, int],
           n_classes: int = 20, stride: int = 3, device="cpu",
           chunk: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Frames (n, T, H, W, 3) uint8 and layouts (n, T, H, W) uint8 of n
    scenes drawn from ``seed``."""
    params, background = scene_params(seed, n, n_classes)
    h, w = hw
    imgs = np.empty((n, n_frames, h, w, 3), np.uint8)
    segs = np.empty((n, n_frames, h, w), np.uint8)
    pal = torch.as_tensor(PALETTE, device=device).float() / 255.0
    shade = 0.7 + 0.3 * torch.linspace(0, 1, h, device=device).view(1, h, 1,
                                                                     1)
    ys = torch.arange(h, device=device).view(1, h, 1)
    xs = torch.arange(w, device=device).view(1, 1, w)
    gen = torch.Generator(device=device).manual_seed(
        (seed & 0xFFFFFFFFFF) << 4 | 5)
    for c0 in range(0, n, chunk):
        p = torch.as_tensor(params[c0:c0 + chunk], device=device)
        bg = torch.as_tensor(background[c0:c0 + chunk], device=device)
        for k in range(n_frames):
            t = k * stride
            seg = bg.view(-1, 1, 1).expand(-1, h, w)
            for s in range(p.shape[1]):
                cls, cy, cx, hh, ww, vy, vx = p[:, s].unbind(-1)
                y, x = cy + vy * t, cx + vx * t
                # int() of the edges truncates toward zero, then clips
                y0 = ((y - hh / 2) * h).trunc().clamp(0, h).view(-1, 1, 1)
                y1 = ((y + hh / 2) * h).trunc().clamp(0, h).view(-1, 1, 1)
                x0 = ((x - ww / 2) * w).trunc().clamp(0, w).view(-1, 1, 1)
                x1 = ((x + ww / 2) * w).trunc().clamp(0, w).view(-1, 1, 1)
                inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
                seg = torch.where(inside, cls.long().view(-1, 1, 1), seg)
            noise = torch.rand(seg.shape + (3,), generator=gen,
                               device=device) * (2 * NOISE) - NOISE
            img = (pal[seg % len(PALETTE)] * shade + noise).clamp(0.0, 1.0)
            imgs[c0:c0 + chunk, k] = (img * 255.0 + 0.5).to(
                torch.uint8).cpu().numpy()
            segs[c0:c0 + chunk, k] = seg.to(torch.uint8).cpu().numpy()
    return imgs, segs
