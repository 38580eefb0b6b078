"""Profiling (the JAX package's ``utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of the host, and of the
  card when there is one, written to ``logdir`` for TensorBoard's profile
  plugin (a ``*.pt.trace.json`` file, which ``chrome://tracing`` and
  Perfetto also read);
- ``annotate(name)``: a named range of host work in that trace;
- ``Throughput``: an items/s counter with EMA smoothing.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the body; yields the ``torch.profiler.profile``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


class Throughput:
    """EMA items/sec counter; call update(n_items) per step."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate = 0.0
        self._last = None

    def update(self, n_items: int) -> float:
        now = time.time()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = n_items / dt
            self.rate = (inst if self.rate == 0.0
                         else self.alpha * inst
                         + (1 - self.alpha) * self.rate)
        self._last = now
        return self.rate
