"""The InstanceNorm kernels of both nets of a GAN step in the profiled
slice as a share of their roofline, in %: ``norm_roofline.resnet``'s
reading of the launches that ``reference/gan_counts.py`` lists (the
generator's and, for each of D's forwards in a step, D's), held against
the program's launch counters and the trace as that reader holds them.

The list assumes D's forwards of the reference's step (``disc_roles``:
fake, real, adversarial). So the program's own count of its D forwards
by role over the traced epoch (``disc_forwards``) is held against it
first: where the program runs other forwards, or does not count them,
the metric reads nothing and says why."""

from pathlib import Path

from benchmark.harness import load_module

_norm = load_module(Path(__file__).with_name("norm_roofline.resnet.py"),
                    "bench_metric_norm_roofline_resnet")
COUNTERS = _norm.COUNTERS


def read(ctx):
    counted, steps = ctx.get("disc_forwards"), ctx.get("epoch_steps")
    log = ctx.get("log", print)
    if counted is None:
        log("norm_roofline: the program counts no D forwards")
        return None
    want = {role: steps if role in ctx["disc_roles"] else 0
            for role in set(counted) | set(ctx["disc_roles"])}
    if any(counted.get(role, 0) != n for role, n in want.items()):
        log(f"norm_roofline: D forwards over {steps} steps {counted}, the "
            f"reference runs {list(ctx['disc_roles'])} a step")
        return None
    return _norm.read(ctx)
