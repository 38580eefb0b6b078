"""Kernels A and B of the profiled slice as a share of their roofline, in %.

For each launch that A and B make in the slice (``conv_launches``: the
cell's launches from the reference's modules at its shapes,
``reference/counts.py``), the least time the card could take,
max(operations / bf16 peak, bytes / HBM peak), summed, over the device
time of the kernels whose names match ``COUNTERS``. The list is held
against the program's launch counters over the slice: where they differ
(another routing), or the trace holds another number of these kernels,
the metric reads nothing and says why."""

from benchmark import peaks

# the program's launch counter -> name patterns of its kernels in a trace
COUNTERS = {"prelu_conv3x3": ("conv3x3_mma_kernel",),
            "fused_lateral": ("fused_lateral_mma_kernel",)}
KIND = {"prelu_conv3x3": "A", "fused_lateral": "B"}


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("conv_launches")
    pk = peaks.lookup(ctx.get("device_name", ""))
    if tr is None or launches is None or pk is None:
        return None
    log = ctx.get("log", print)
    for counter, pats in COUNTERS.items():
        want = sum(1 for x in launches if x.kind == KIND[counter])
        moved = ctx["counters"].get(counter, 0)
        if want != moved or tr.count(pats) != moved:
            log(f"conv_roofline: {counter} launched {moved} times, the "
                f"reference lists {want}, the trace holds {tr.count(pats)}")
            return None
    bound = sum(max(x.flops / pk.bf16_flops, x.bytes / pk.bytes_per_s)
                for x in launches)
    spent = sum(tr.device_s(p) for p in COUNTERS.values())
    return 100.0 * bound / spent if spent > 0 else None
