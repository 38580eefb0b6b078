"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version and a launch counter (``<wrapper>.launches``)."""

from .conv3x3 import prelu_conv3x3, prelu_conv3x3_plain
from .lateral import fused_lateral, fused_lateral_plain
from .ssim import ssim_loss, ssim_planes, ssim_planes_plain

WRAPPERS = (prelu_conv3x3, fused_lateral, ssim_loss)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["prelu_conv3x3", "prelu_conv3x3_plain", "fused_lateral",
           "fused_lateral_plain", "ssim_loss", "ssim_planes",
           "ssim_planes_plain", "reset_launch_counts", "launch_counts"]
