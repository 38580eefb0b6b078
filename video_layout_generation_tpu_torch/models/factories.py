"""Generator and discriminator factories (the JAX package's
``models/factories.py``): string-keyed construction of the pix2pix nets.
A torch module holds its own initialized parameters, so each factory
returns the module alone; ``generator`` seeds the weights."""

from __future__ import annotations

from typing import Optional

import torch

from .discriminators import NLayerDiscriminator, PixelDiscriminator
from .resnet_gen import ResnetGenerator
from .unet_gen import UnetGenerator


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str,
             norm: str = "batch", use_dropout: bool = False,
             init_type: str = "normal", init_gain: float = 0.02,
             dtype: Optional[torch.dtype] = None, seg_out: int = 20,
             generator: Optional[torch.Generator] = None):
    common = dict(input_nc=input_nc, output_nc=output_nc, ngf=ngf, norm=norm,
                  use_dropout=use_dropout, init_type=init_type,
                  init_gain=init_gain, dtype=dtype, generator=generator)
    if netG == "resnet_9blocks":
        return ResnetGenerator(n_blocks=9, seg_out=seg_out, **common)
    if netG == "resnet_6blocks":
        return ResnetGenerator(n_blocks=6, seg_out=seg_out, **common)
    if netG == "unet_256":
        return UnetGenerator(num_downs=8, **common)
    if netG == "unet_128":
        return UnetGenerator(num_downs=7, **common)
    raise NotImplementedError(
        f"Generator model name [{netG}] is not recognized")


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3,
             norm: str = "batch", init_type: str = "normal",
             init_gain: float = 0.02, dtype: Optional[torch.dtype] = None,
             generator: Optional[torch.Generator] = None):
    common = dict(input_nc=input_nc, ndf=ndf, norm=norm, init_type=init_type,
                  init_gain=init_gain, dtype=dtype, generator=generator)
    if netD == "basic":          # 70x70 PatchGAN
        return NLayerDiscriminator(n_layers=3, **common)
    if netD == "n_layers":
        return NLayerDiscriminator(n_layers=n_layers_D, **common)
    if netD == "pixel":
        return PixelDiscriminator(**common)
    raise NotImplementedError(
        f"Discriminator model name [{netD}] is not recognized")
