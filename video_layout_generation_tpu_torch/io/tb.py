"""TensorBoard writer shim (the JAX package's ``io/tb.py``): tensorboardX
where it is installed, a no-op otherwise. Takes NHWC numpy arrays or
tensors."""

from __future__ import annotations

import numpy as np
import torch

try:
    from tensorboardX import SummaryWriter as _TBX
except ImportError:  # pragma: no cover - depends on the machine
    _TBX = None


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class SummaryWriter:
    def __init__(self, logdir=None, enabled: bool = True):
        self._w = _TBX(logdir) if (enabled and _TBX is not None
                                   and logdir is not None) else None

    @property
    def active(self) -> bool:
        return self._w is not None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def add_image(self, tag, img_nhwc, step, max_images: int = 8):
        """img_nhwc: (N,H,W,C) in [0,1]; writes a simple grid."""
        if self._w is None:
            return
        arr = np.clip(_np(img_nhwc)[:max_images], 0.0, 1.0)
        n, h, w, c = arr.shape
        grid = arr.transpose(1, 0, 2, 3).reshape(h, n * w, c)
        self._w.add_image(tag, grid.transpose(2, 0, 1), int(step))

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
