"""Model FLOPs of a GAN step (the reference's generator and discriminator
forwards and backwards, ``reference/gan_counts.py``) times the steps of
the window, over the window's time, as a share of the card's bf16 dense
peak, in %: ``mfu.train``'s reading of the driver's ``flops_per_step``."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("mfu.train.py"),
                   "bench_metric_mfu_train").read
