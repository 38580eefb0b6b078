"""Random weights of a ResNet generator configuration from the seed, made on
the card in one draw a net.

The generator is initialized as pix2pix initializes it (``init_type``
normal, ``init_gain`` 0.02: every kernel normal with standard deviation
0.02, every bias 0), from the same seeded generator that ``weights.py``
draws a configuration's generator from. HED and the VGG19 trunk are drawn
by ``weights.make`` exactly as for the GridNet configurations.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import weights
from benchmark.reference import nets
from benchmark.reference.resnet_gen import spec_of


def generator(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = spec_of(config)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFFFF) << 4) | weights.NET_SALT["gen"])
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        v = flat[at:at + size].view(shape)
        at += size
        out[name] = (v * config["init_gain"] if kind == "kernel"
                     else torch.zeros(shape, device=device)).contiguous()
    return out


def for_config(config: dict, seed: int, device
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of the generator (``gen``), HED (``hned``) and the VGG19
    trunk (``vgg``)."""
    return {"gen": generator(config, seed, device),
            "hned": weights.make(nets.hned_spec(), seed, "hned", 2.0,
                                 config["weights"]["hned_scale"], device),
            "vgg": weights.make(nets.vgg_spec(), seed, "vgg", 2.0, {},
                                device)}
