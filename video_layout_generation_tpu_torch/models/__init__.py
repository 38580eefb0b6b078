"""Model registry of the port (the JAX package's ``get_model_cls``).

Left out, as TPU adapters of the JAX package: ``make_packed_gridnet_apply``
and ``make_edge_rollout_apply`` (``models/fast_gridnet.py``, the packed
GridNet forward of the Pallas kernels).
"""

from .blocks import (CoordConv, CoordDownSamplingBlock, CoordLateralBlock,
                     CoordUpSamplingBlock, DownSamplingBlock, LateralBlock,
                     PReLU, UpSamplingBlock)
from .convlstm import ConvLSTMCell, ConvLSTMLayoutPredictor
from .discriminators import NLayerDiscriminator, PixelDiscriminator
from .factories import define_D, define_G
from .gridnet import CoordGridNet, GridNet
from .hned import HNED, hned_fused_edge
from .init import get_initializer
from .legacy import (EncoderDecoder, Simple, UNet, simple29_encoderdecoder,
                     simple29_unet)
from .norms import BatchNorm, InstanceNorm, get_norm_layer
from .resnet_gen import ResnetBlock, ResnetGenerator
from .unet_gen import UnetGenerator, UnetSkipBlock
from .vae import LayoutCVAE, LayoutVAE, make_cvae_rollout

_REGISTRY = {
    "GridNet": GridNet,
    "CoordGridNet": CoordGridNet,
    "ResnetGenerator": ResnetGenerator,
    "UnetGenerator": UnetGenerator,
    "NLayerDiscriminator": NLayerDiscriminator,
    "PixelDiscriminator": PixelDiscriminator,
    "HNED": HNED,
    "LayoutVAE": LayoutVAE,
    "LayoutCVAE": LayoutCVAE,
    "ConvLSTMLayoutPredictor": ConvLSTMLayoutPredictor,
    "UNet": UNet,
    "EncoderDecoder": EncoderDecoder,
    "simple29_unet": simple29_unet,
    "simple29_encoderdecoder": simple29_encoderdecoder,
}


def get_model_cls(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = list(_REGISTRY) + [
    "get_model_cls", "hned_fused_edge", "Simple", "PReLU", "LateralBlock", "DownSamplingBlock",
    "UpSamplingBlock", "CoordConv", "CoordLateralBlock",
    "CoordDownSamplingBlock", "CoordUpSamplingBlock", "define_G", "define_D",
    "get_initializer", "get_norm_layer", "InstanceNorm", "BatchNorm",
    "ResnetBlock", "UnetSkipBlock", "make_cvae_rollout", "ConvLSTMCell"]
