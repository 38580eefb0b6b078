"""Device time of a request's fetch, in ms: the ``Memcpy DtoH`` records of
the trace whose middle lies inside one of the program's ``serve.fetch``
spans (the result's copy to the host) that lie wholly inside the profiled
slice, summed, over the number of those spans. Nothing where the slice
holds no whole ``serve.fetch``, or fewer such records than fetches: the
profiler drops copy records now and then."""

COPY = "Memcpy DtoH"


def inside(tr, name):
    """(start, end) of the host spans ``name`` wholly inside the slice."""
    lo, hi = tr.window
    return [(s, e) for n, s, e in tr.host if n == name and lo <= s
            and e <= hi]


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    log = ctx.get("log", print)
    fetches = inside(tr, "serve.fetch")
    if not fetches:
        log("fetch_ms: the slice holds no whole serve.fetch span")
        return None
    copies = [e - s for n, s, e in tr.device if COPY in n
              and any(fs <= (s + e) / 2 <= fe for fs, fe in fetches)]
    if len(copies) < len(fetches):
        log(f"fetch_ms: {len(copies)} {COPY} records in "
            f"{len(fetches)} fetches")
        return None
    return sum(copies) / 1e3 / len(fetches)
