"""Model FLOPs of a request (the reference's rollout) over the mean time a
request was served in the window, as a share of the card's bf16 dense
peak, in %."""

from benchmark import peaks


def read(ctx):
    if ctx.get("kind") != "rollout":
        return None
    s = ctx["window"]["service_s"]
    rate = ctx["flops_per_request"] * len(s) / sum(s)
    pk = peaks.lookup(ctx.get("device_name", ""))
    if pk is None:
        return None
    return 100.0 * rate / pk.bf16_flops
