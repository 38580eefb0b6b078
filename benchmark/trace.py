"""A profiled slice of a run, read from the profiler's trace.

``Slice`` (or ``profiled(fn, sync)`` around one call) runs under
``torch.profiler`` (host and card), inside a ``bench.slice`` span, and
reads the Chrome trace it exports: every kernel, copy and memset on the
card (the device intervals), and the host's spans and operators on the
launching thread. The device is
busy for the union of its intervals, not their sum: the loader's copies
run on a side stream beside the kernels. The trace file is written under
the temporary directory and removed once read.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
SLICE = "bench.slice"
TRACE_TRIES = 3     # a slice is taken again while its trace misses launches


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    wall_s: float                       # the slice on the host's clock
    window: Tuple[float, float]         # the slice in the trace's us
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for _, s, e in self.device
                if e > lo and s < hi]

    @property
    def busy_s(self) -> float:
        return union_length(self.intervals()) / 1e6

    def count(self, patterns: Sequence[str]) -> int:
        return sum(1 for name, _, _ in self.device
                   if any(p in name for p in patterns))

    def device_s(self, patterns: Sequence[str]) -> float:
        return sum(e - s for name, s, e in self.device
                   if any(p in name for p in patterns)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        time by what the host was doing: the innermost host operator or
        benchmark span (``bench.*``) around the gap's middle, else ``host
        idle``."""
        ops: Dict[str, float] = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        idle: Dict[str, float] = {}
        for s, e in gaps(self.intervals(), *self.window):
            label = self.host_label((s + e) / 2)
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
        return {"device_ops": [[k, v] for k, v in rank(ops)],
                "idle_gaps": [[k, v] for k, v in rank(idle)]}

    def host_label(self, t: float) -> str:
        spans = [(e - s, n) for n, s, e in self.host
                 if s <= t <= e and n != SLICE]
        return min(spans)[1] if spans else "host idle"


class Slice:
    """A profiled slice that starts and stops where the caller says, also
    inside a loop the program runs (``start()``, then ``stop(sync)``)."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function(SLICE)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, sync: Callable) -> Trace:
        sync()
        wall = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        del self.prof
        return read_events(events, wall)


def profiled(fn: Callable, sync: Callable) -> Tuple[object, Trace]:
    """Run ``fn()`` (then ``sync()``) under the profiler; its result and the
    trace of the slice."""
    sl = Slice()
    sl.start()
    out = fn()
    return out, sl.stop(sync)


def read_events(events: List[dict], wall_s: float) -> Trace:
    """The slice's device intervals and launching-thread host spans from
    Chrome trace events."""
    window = None
    for ev in events:
        if (ev.get("name") == SLICE and ev.get("ph") == "X"
                and ev.get("cat") == "user_annotation"):
            window = (ev["ts"], ev["ts"] + ev["dur"])
            tid = ev.get("tid")
    if window is None:
        raise RuntimeError("the profiler's trace holds no slice span")
    tr = Trace(wall_s=wall_s, window=window)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        span = (ev["name"], float(ev["ts"]), float(ev["ts"] + ev["dur"]))
        if cat in DEVICE_CATS:
            tr.device.append(span)
        elif cat in HOST_CATS and ev.get("tid") == tid:
            tr.host.append(span)
    return tr
