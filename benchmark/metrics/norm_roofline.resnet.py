"""The InstanceNorm kernels of the profiled slice as a share of their
roofline, in %.

For each forward and backward launch of the InstanceNorm kernels in the
slice (``norm_launches``: the reference's list at the cell's shapes,
``reference/resnet_counts.py``), the least time the card could take,
max(bytes / HBM peak, operations / float32 peak), summed, over the device
time of the kernels whose names match ``COUNTERS``. The list is held
against the program's launch counters over the slice, and both against
the trace: where they differ (a forward that kept nothing, another
routing, a trace that misses launches), the metric reads nothing and says
why."""

from benchmark import peaks

# the program's launch counter -> name patterns of its kernels in a trace
COUNTERS = {"instance_norm_fwd": ("instance_norm_fwd_kernel",),
            "instance_norm_bwd": ("instance_norm_bwd_kernel",)}
KIND = {"instance_norm_fwd": "norm_fwd", "instance_norm_bwd": "norm_bwd"}


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("norm_launches")
    pk = peaks.lookup(ctx.get("device_name", ""))
    if tr is None or launches is None or pk is None:
        return None
    log = ctx.get("log", print)
    unkept = ctx["counters"].get("instance_norm_fwd_only", 0)
    if unkept:
        log(f"norm_roofline: {unkept} forward launches kept nothing")
        return None
    for counter, pats in COUNTERS.items():
        want = sum(1 for x in launches if x.kind == KIND[counter])
        moved = ctx["counters"].get(counter, 0)
        if want != moved or tr.count(pats) != moved:
            log(f"norm_roofline: {counter} launched {moved} times, the "
                f"reference lists {want}, the trace holds {tr.count(pats)}")
            return None
    bound = sum(max(x.flops / pk.f32_flops, x.bytes / pk.bytes_per_s)
                for x in launches)
    spent = sum(tr.device_s(p) for p in COUNTERS.values())
    return 100.0 * bound / spent if spent > 0 else None
