"""Host time the trainer takes to launch a train step, in ms: the mean
length of the program's ``train.step`` spans (the call of the step, from
the decode of its batch to the optimizer's update) that lie wholly inside
the profiled slice. The card runs the step after the host returns, so this
is the enqueue, not the step's device time. Nothing where the slice holds
no whole ``train.step``."""


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    steps = inside(tr, "train.step")
    if not steps:
        ctx.get("log", print)("step_enqueue_ms: the slice holds no whole "
                              "train.step span")
        return None
    return sum(e - s for s, e in steps) / 1e3 / len(steps)
