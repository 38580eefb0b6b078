"""Host time the rollout takes to launch one generated frame, in ms: the
mean length of the program's ``rollout.frame`` spans (GridNet and the
frame's HED edges) that lie wholly inside the profiled slice. Nothing
where the slice holds no whole ``rollout.frame``."""


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    frames = inside(tr, "rollout.frame")
    if not frames:
        ctx.get("log", print)("frame_enqueue_ms: the slice holds no whole "
                              "rollout.frame span")
        return None
    return sum(e - s for s, e in frames) / 1e3 / len(frames)
