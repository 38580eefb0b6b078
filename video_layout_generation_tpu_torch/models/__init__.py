"""Model registry of the port (the JAX package's ``get_model_cls``)."""

from .blocks import (CoordConv, CoordDownSamplingBlock, CoordLateralBlock,
                     CoordUpSamplingBlock, DownSamplingBlock, LateralBlock,
                     PReLU, UpSamplingBlock)
from .convlstm import ConvLSTMCell, ConvLSTMLayoutPredictor
from .discriminators import NLayerDiscriminator, PixelDiscriminator
from .factories import define_D, define_G
from .gridnet import CoordGridNet, GridNet
from .hned import HNED, hned_fused_edge
from .init import get_initializer
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
    "LayoutVAE": LayoutVAE,
    "LayoutCVAE": LayoutCVAE,
    "ConvLSTMLayoutPredictor": ConvLSTMLayoutPredictor,
}


def get_model_cls(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = list(_REGISTRY) + [
    "get_model_cls", "HNED", "hned_fused_edge", "PReLU", "LateralBlock", "DownSamplingBlock",
    "UpSamplingBlock", "CoordConv", "CoordLateralBlock",
    "CoordDownSamplingBlock", "CoordUpSamplingBlock", "define_G", "define_D",
    "get_initializer", "get_norm_layer", "InstanceNorm", "BatchNorm",
    "ResnetBlock", "UnetSkipBlock", "make_cvae_rollout", "ConvLSTMCell"]
