"""Share of the profiled slice in which nothing ran on the card, in %: one
less the union of the kernel, copy and memset intervals of the trace over
the slice's length."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
