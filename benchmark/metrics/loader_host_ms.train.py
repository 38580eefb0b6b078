"""Host time the loader spends on the launching thread a batch, in ms: the
program's ``loader.collate`` (stack and uint8 pack), ``loader.pin`` (the
pinned fill, with its wait on the buffer's last copy) and ``loader.copy``
(the launch of the copy to the card) spans that lie wholly inside the
profiled slice, summed, over the number of its ``loader.copy`` spans (one
a batch). Nothing where the slice holds no whole ``loader.copy``."""

PARTS = ("loader.collate", "loader.pin", "loader.copy")


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    batches = len(inside(tr, "loader.copy"))
    if not batches:
        ctx.get("log", print)("loader_host_ms: the slice holds no whole "
                              "loader.copy span")
        return None
    host = sum(e - s for name in PARTS for s, e in inside(tr, name))
    return host / 1e3 / batches
