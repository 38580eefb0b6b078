"""Host time of the ResNet generator's forward in a train step, in ms: the
program's ``gen.stem``, ``gen.blocks`` and ``gen.up`` spans (the stem and
downsampling, the residual blocks, the upsampling and heads) that lie
wholly inside the profiled slice, summed, over the number of forwards
(``gen.stem`` spans). The card runs the forward after the host returns,
so this is its enqueue. Nothing where the slice holds no whole forward,
or where the three spans' counts differ."""

PARTS = ("gen.stem", "gen.blocks", "gen.up")


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    spans = {name: inside(tr, name) for name in PARTS}
    counts = {name: len(v) for name, v in spans.items()}
    if not counts["gen.stem"] or len(set(counts.values())) != 1:
        ctx.get("log", print)(f"gen_forward_ms: whole generator spans in "
                              f"the slice: {counts}")
        return None
    host = sum(e - s for v in spans.values() for s, e in v)
    return host / 1e3 / counts["gen.stem"]
