"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version and its launch counters (``<wrapper>.launches``; the InstanceNorm
wrapper counts its forward, forward-only and backward launches apart)."""

from .conv3x3 import prelu_conv3x3, prelu_conv3x3_plain
from . import instance_norm   # the module: its wrapper shares its name
from .lateral import fused_lateral, fused_lateral_plain
from .ssim import ssim_loss, ssim_planes, ssim_planes_plain

# counter name -> (wrapper, attribute)
COUNTERS = {
    "prelu_conv3x3": (prelu_conv3x3, "launches"),
    "fused_lateral": (fused_lateral, "launches"),
    "ssim_loss": (ssim_loss, "launches"),
    "instance_norm_fwd": (instance_norm.instance_norm, "launches_fwd"),
    "instance_norm_fwd_only": (instance_norm.instance_norm,
                               "launches_fwd_only"),
    "instance_norm_bwd": (instance_norm.instance_norm, "launches_bwd"),
}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def add_launch_counts(moved: dict) -> None:
    """Add ``moved`` (counter name -> launches, negative to take away) to
    the counters. The wrappers count in Python, so a CUDA graph's capture
    moves them though it launches nothing, and its replay launches without
    moving them: the graph's owner takes the capture's count away and adds
    it on every replay."""
    for name, k in moved.items():
        fn, attr = COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + k)


__all__ = ["prelu_conv3x3", "prelu_conv3x3_plain", "fused_lateral",
           "fused_lateral_plain", "ssim_loss", "ssim_planes",
           "ssim_planes_plain", "instance_norm", "reset_launch_counts",
           "launch_counts", "add_launch_counts"]
