"""Profiling (the JAX package's ``utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of the host, and of the
  card when there is one, written to ``logdir`` for TensorBoard's profile
  plugin (a ``*.pt.trace.json`` file, which ``chrome://tracing`` and
  Perfetto also read);
- ``annotate(name)``: the port's span, a named range of host work in any
  ``torch.profiler`` trace that is recording on the calling thread, on the
  clock of the card's kernels and copies. With no profiler recording it is
  one shared null context: a span then costs one check.

The program's spans sit at its layer boundaries (README, "Tracing a
run"); parent and child come from nesting on the thread. The profiler
keeps them in memory and writes them out when it stops.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


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
    """A ``record_function(name)`` range while a profiler records on this
    thread, else the shared null context. Close it before a generator
    yields: a span belongs to one stretch of the thread's work."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
