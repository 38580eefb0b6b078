"""Model FLOPs of a train step (the reference's forward and backward, no
recomputation) times the steps of the window, over the window's time, as a
share of the card's bf16 dense peak, in %."""

from benchmark import peaks


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    w = ctx["window"]
    rate = ctx["flops_per_step"] * w["steps"] / w["wall_s"]
    pk = peaks.lookup(ctx.get("device_name", ""))
    if pk is None:
        return None
    return 100.0 * rate / pk.bf16_flops
