"""Model FLOPs of a ResNet generator's train step (the reference's forward
and backward, ``reference/resnet_counts.py``) times the steps of the
window, over the window's time, as a share of the card's bf16 dense peak,
in %: ``mfu.train``'s reading of the driver's ``flops_per_step``."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("mfu.train.py"),
                   "bench_metric_mfu_train").read
