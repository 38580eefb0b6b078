"""Host time a train step waits for its batch, in ms: ``Trainer.epoch_stats``
``load_s`` (the host's clock around the loader's ``next``) summed over the
window's epochs, over their steps."""


def read(ctx):
    w = ctx.get("window")
    if ctx.get("kind") != "train" or not w or not w.get("steps"):
        return None
    return 1e3 * w["load_s"] / w["steps"]
