"""Host-side meters (the JAX package's ``utils/meters.py``):
``AverageMeter``, a running average, and ``StepTimer``, the load / compute
split the training loop logs per step, on ``time.perf_counter`` (a clock
that does not step)."""

from __future__ import annotations

import time


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StepTimer:
    """Tracks alternating load/compute intervals."""

    def __init__(self):
        self._last = time.perf_counter()
        self.load_time = 0.0
        self.comp_time = 0.0

    def mark_loaded(self):
        now = time.perf_counter()
        self.load_time = now - self._last
        self._last = now

    def mark_computed(self):
        now = time.perf_counter()
        self.comp_time = now - self._last
        self._last = now
