"""Random weights from the seed, made on the card in one draw a net.

Scaled as the port's on-card smoke test scales its random weights: 3 x 3
and 1 x 1 kernels normal with variance ``gain / fan_in`` (``gain`` 1 for
the generator, 2 for the ReLU nets HED and VGG19), biases 0.1 x normal,
PReLU slopes 0.25. A configuration may scale named leaves further
(``"scale"``: ``fnmatch`` pattern of a leaf's name -> factor): HED's 1 x 1
score kernels, so that its [0, 255]-ranged input gives scores of order 1
and the sigmoid does not saturate, and the generator's image head, so
that its frames lie inside [0, 1] as a trained model's do and the served
frames are seldom clipped.
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict, Mapping

import torch

from benchmark.reference import nets

NET_SALT = {"gen": 1, "hned": 2, "vgg": 3}


def make(spec, seed: int, net: str, gain: float, scale: Mapping[str, float],
         device) -> Dict[str, torch.Tensor]:
    """Float32 leaves of ``spec`` ((name, shape, kind) triples) on
    ``device``, from one normal draw of a generator seeded with
    (seed, net)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFFFF) << 4) | NET_SALT[net])
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        v = flat[at:at + size].view(shape)
        at += size
        if kind == "kernel":
            v = v * math.sqrt(gain / math.prod(shape[:3]))
        elif kind == "bias":
            v = v * 0.1
        else:
            v = torch.full(shape, 0.25, device=device)
        for pattern, factor in scale.items():
            if fnmatch.fnmatchcase(name, pattern):
                v = v * factor
        out[name] = v.contiguous()
    return out


def for_config(config: dict, seed: int, device, names=("gen", "hned", "vgg")
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of a configuration's nets, by name: the generator
    (``gen``), HED (``hned``) and the VGG19 trunk (``vgg``)."""
    wc = config["weights"]
    specs = {"gen": (nets.gridnet_spec(config["n_channels"],
                                       config["filters_level"],
                                       config["arch"] == "CoordGridNet"),
                     1.0, wc["gen_scale"]),
             "hned": (nets.hned_spec(), 2.0, wc["hned_scale"]),
             "vgg": (nets.vgg_spec(), 2.0, {})}
    return {n: make(specs[n][0], seed, n, specs[n][1], specs[n][2], device)
            for n in names}
