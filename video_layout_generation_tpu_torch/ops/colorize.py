"""Segmentation ids -> RGB through the Cityscapes palette (the JAX
package's ``ops/colorize.py``), on tensors: a gather from the palette, on
the ids' device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Cityscapes train-id palette; index 19 is the void/ignore class.
CITYSCAPES_COLORS = np.array([
    [128, 64, 128],    # road
    [244, 35, 232],    # sidewalk
    [70, 70, 70],      # building
    [102, 102, 156],   # wall
    [190, 153, 153],   # fence
    [153, 153, 153],   # pole
    [250, 170, 30],    # traffic light
    [220, 220, 0],     # traffic sign
    [107, 142, 35],    # vegetation
    [152, 251, 152],   # terrain
    [70, 130, 180],    # sky
    [220, 20, 60],     # person
    [255, 0, 0],       # rider
    [0, 0, 142],       # car
    [0, 0, 70],        # truck
    [0, 60, 100],      # bus
    [0, 80, 100],      # train
    [0, 0, 230],       # motorcycle
    [119, 11, 32],     # bicycle
    [0, 0, 0],         # none / void
], dtype=np.uint8)


def colorize_seg(seg: torch.Tensor, n_classes: int = 20, argmax: bool = False,
                 palette: Optional[np.ndarray] = None) -> torch.Tensor:
    """Integer ids (..., H, W), or logits (..., H, W, C) with ``argmax``,
    -> f32 RGB in [0, 1] (..., H, W, 3). Ids index the first ``n_classes``
    palette entries."""
    pal = CITYSCAPES_COLORS if palette is None else palette
    seg = torch.as_tensor(seg)
    if argmax:
        seg = seg.argmax(dim=-1)
    lut = torch.as_tensor(np.asarray(pal[:n_classes], np.float32) / 255.0,
                          device=seg.device)
    return lut[seg.long()]
