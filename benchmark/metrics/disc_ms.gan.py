"""Host time of the discriminator's work in a GAN step, in ms: the
program's ``gan.disc`` (both D forwards, D's loss and gradients),
``gan.disc_update`` (D's all-reduce and Adam) and ``gan.adv`` (the frozen
D's forward and G's four loss terms) spans that lie wholly inside the
profiled slice, summed, over the number of steps (``gan.disc`` spans). The
card runs that work after the host returns, so this is its enqueue.
Nothing where the slice holds no whole step's spans, or where the three
spans' counts differ."""

from pathlib import Path

from benchmark.harness import load_module

PARTS = ("gan.disc", "gan.disc_update", "gan.adv")
inside = load_module(Path(__file__).with_name("gen_forward_ms.resnet.py"),
                     "bench_metric_gen_forward_ms_resnet").inside


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    spans = {name: inside(tr, name) for name in PARTS}
    counts = {name: len(v) for name, v in spans.items()}
    if not counts["gan.disc"] or len(set(counts.values())) != 1:
        ctx.get("log", print)(f"disc_ms: whole GAN-step spans in the "
                              f"slice: {counts}")
        return None
    host = sum(e - s for v in spans.values() for s, e in v)
    return host / 1e3 / counts["gan.disc"]
