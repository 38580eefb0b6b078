"""Host time of a request outside its launches and fetch, in ms: the
program's ``serve.pack`` (the request packed into one array),
``serve.upload`` (its copy to the card) and ``serve.decode`` (the answer
unpacked) spans that lie wholly inside the profiled slice, summed, over
the number of its ``serve.request`` spans. Nothing where the slice holds
no whole ``serve.request``."""

PARTS = ("serve.pack", "serve.upload", "serve.decode")


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    requests = len(inside(tr, "serve.request"))
    if not requests:
        ctx.get("log", print)("request_host_ms: the slice holds no whole "
                              "serve.request span")
        return None
    host = sum(e - s for name in PARTS for s, e in inside(tr, name))
    return host / 1e3 / requests
