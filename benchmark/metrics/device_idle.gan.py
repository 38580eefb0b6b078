"""Share of the profiled slice of GAN training in which nothing ran on the
card, in %: ``device_idle.train``'s reading (one less the union of the
kernel, copy and memset intervals over the slice)."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("device_idle.train.py"),
                   "bench_metric_device_idle_train").read
