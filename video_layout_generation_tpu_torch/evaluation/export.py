"""Prediction export (the JAX package's ``evaluation/export.py``):
colorized layout PNGs and raw ``.npy`` stacks of validation inputs and
predictions and of rollouts. PNGs go through the native writer
(``io/native_loader.py``, libdeflate) when it builds, else cv2 / PIL."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..io.native_loader import NativeImageLoader
from ..ops.colorize import CITYSCAPES_COLORS

_native_writer = None


def png_writer():
    """The native PNG writer, or False when it cannot be built or loaded
    (made once)."""
    global _native_writer
    if _native_writer is None:
        try:
            _native_writer = NativeImageLoader(n_threads=1)
        except OSError:
            _native_writer = False
    return _native_writer


def save_colorized_png(path: str, seg_ids, palette: np.ndarray = None):
    """seg_ids: (H, W) integer class map -> RGB PNG, through the native
    writer, else cv2, else PIL."""
    pal = CITYSCAPES_COLORS if palette is None else palette
    ids = (seg_ids.detach().cpu().numpy() if isinstance(seg_ids, torch.Tensor)
           else np.asarray(seg_ids))
    rgb = pal[ids.astype(np.int64) % len(pal)].astype(np.uint8)
    writer = png_writer()
    if writer:
        # level 1, as the JAX package's export: throughput over file size
        writer.save_png(path, rgb, level=1)
        return
    try:
        import cv2
    except ImportError:
        from PIL import Image
        Image.fromarray(rgb).save(path)
        return
    cv2.imwrite(path, rgb[..., ::-1])  # cv2 writes BGR


def save_npy_stack(directory: str, tag: str, arrays: Dict[str, object]):
    """Dump named arrays (numpy or tensors) as <dir>/<tag>_<name>.npy."""
    os.makedirs(directory, exist_ok=True)
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        np.save(os.path.join(directory, f"{tag}_{name}.npy"),
                np.asarray(arr))
