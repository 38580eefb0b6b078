"""Tensor ops of the port: resize, pooling, the palette, one-hot, CoordConv
channels, boxes and the CUDA kernels (``ops/kernels``).

Left out, as TPU adapters of the JAX package: the packed-layout adapters of
``ops/packed.py``, the ``ops/pallas`` kernels (``ops/kernels`` holds their
CUDA counterparts) and ``upsample2x_phases``,
``upsample2x_bilinear_align_stencil`` and ``upsample2x_align_to_1x2``.
"""

from .boxes import mask2box
from .colorize import CITYSCAPES_COLORS, colorize_seg
from .coords import add_coord_channels
from .one_hot import seg_one_hot
from .pooling import avg_pool_3x3_valid, max_pool_2x2
from .resize import (interp_matrix, resize_bilinear, resize_nearest,
                     upsample2x_bilinear_align)

__all__ = [
    "resize_bilinear",
    "resize_nearest",
    "upsample2x_bilinear_align",
    "interp_matrix",
    "avg_pool_3x3_valid",
    "max_pool_2x2",
    "CITYSCAPES_COLORS",
    "colorize_seg",
    "seg_one_hot",
    "add_coord_channels",
    "mask2box",
]
