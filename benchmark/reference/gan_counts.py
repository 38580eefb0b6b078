"""The work of the pix2pix GAN step on a ResNet generator: model FLOPs, and
the operations and bytes of each launch of the port's InstanceNorm kernels
in both nets.

Model FLOPs are counted as ``resnet_counts.py`` counts them:
``FlopCounterMode`` over the plain reference (``resnet_gan.py``) on the meta
device at the cell's shapes, in the step's order and with no recomputation:
the generator's forward once; D's forwards of the detached fake pair and of
the real pair with D's weight gradients; the frozen D's forward of the
fake pair with G's four terms, and G's gradients through it (D's data
gradient only). HED and the VGG19 trunk are counted as in the train step.

The InstanceNorm launches: the generator's (``resnet_counts``: a forward
that keeps y and rstd for each of its norms, and a backward for each),
and, for each of D's forwards in the step (``ROLES``), a forward that keeps
y and rstd and a backward for each of D's norms: the fake and real
forwards' backwards carry D's weight gradients, the adversarial forward's
G's gradient through D. A launch's work is ``resnet_counts.norm_launch``'s.
"""

from __future__ import annotations

from typing import List

import torch

from . import counts, nets, train
from .counts import Launch
from .resnet_counts import forward_shapes, norm_launch
from .resnet_gan import (d_loss, disc_spec_of, discriminator, gan_inputs,
                         gan_loss, pair)
from .resnet_gen import Nets, spec_of

# D's forwards in one step, by the role the program counts them under
ROLES = ("fake", "real", "adv")


def disc_forward_shapes(config: dict, batch: int) -> List[tuple]:
    """(n, h, w, c) of each InstanceNorm of one D forward, in order."""
    h, w = config["image_hw"]
    disc = counts.meta_params(disc_spec_of(config))
    x = torch.empty((batch, config["disc_input_nc"], h, w), device="meta")
    shapes: List[tuple] = []
    discriminator(disc, x, norm_rec=lambda *s: shapes.append(s))
    return shapes


def roles(config: dict) -> tuple:
    """D's forwards a step under the configuration's GAN loss."""
    if config["gan_mode"] not in ("lsgan", "vanilla"):
        raise ValueError(f"no count of a {config['gan_mode']!r} step")
    return ROLES


def step_norm_launches(config: dict, traffic: dict) -> List[Launch]:
    """The InstanceNorm launches of one GAN step: every forward, then every
    backward, the generator's before D's."""
    g = forward_shapes(config, traffic["batch"])
    d = disc_forward_shapes(config, traffic["batch"]) * len(roles(config))
    return ([norm_launch(*s) for s in g + d]
            + [norm_launch(*s, backward=True) for s in g + d])


def step_flops(config: dict, traffic: dict) -> int:
    """Model FLOPs of one GAN step at the cell's batch."""
    b, hw = traffic["batch"], tuple(config["image_hw"])
    mode, w = config["gan_mode"], config["loss_weights"]
    gen = counts.meta_params(spec_of(config))
    disc = counts.meta_params(disc_spec_of(config))
    nt = Nets(gen, counts.meta_params(nets.hned_spec()),
              counts.meta_params(nets.vgg_spec()))
    imgs = torch.empty((b, 3) + hw + (3,), device="meta")
    segs = torch.zeros((b, 3) + hw, dtype=torch.long, device="meta")

    def step():
        for v in list(gen.values()) + list(disc.values()):
            v.requires_grad_(True)
        inp = gan_inputs(nt, imgs, segs, False)
        rec, _, img_n = train.terms(nt, inp["x"], inp["f3n"], inp["s3"], w)
        torch.autograd.grad(d_loss(disc, inp, img_n, mode),
                            list(disc.values()))
        for v in disc.values():
            v.requires_grad_(False)
        adv = gan_loss(discriminator(disc, pair(inp, img_n)), True, mode)
        torch.autograd.grad(adv + rec.sum(), list(gen.values()))
    return counts.model_flops(step)
