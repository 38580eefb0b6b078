"""Random weights of a GAN configuration from the seed, made on the card in
one draw a net.

The generator, HED and the VGG19 trunk are drawn by ``resnet_weights.py``.
The discriminator is initialized as pix2pix initializes it
(``disc_init_type`` normal, ``disc_init_gain`` 0.02: every kernel normal
with standard deviation 0.02, every bias 0), from a generator seeded with
the seed and a salt of its own, so that its draw is independent of the
other nets'.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import resnet_weights
from benchmark.reference.resnet_gan import disc_spec_of

DISC_SALT = 4       # beside weights.NET_SALT's 1, 2 and 3


def discriminator(config: dict, seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    spec = disc_spec_of(config)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFFFF) << 4) | DISC_SALT)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        v = flat[at:at + size].view(shape)
        at += size
        out[name] = (v * config["disc_init_gain"] if kind == "kernel"
                     else torch.zeros(shape, device=device)).contiguous()
    return out


def for_config(config: dict, seed: int, device
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of the generator (``gen``), the discriminator
    (``disc``), HED (``hned``) and the VGG19 trunk (``vgg``)."""
    return dict(resnet_weights.for_config(config, seed, device),
                disc=discriminator(config, seed, device))
