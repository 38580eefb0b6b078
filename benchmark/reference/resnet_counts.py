"""The work of a ResNet generator's train step: model FLOPs, and the
operations and bytes of each launch of the port's InstanceNorm kernels.

Model FLOPs are counted as ``counts.py`` counts them: ``FlopCounterMode``
over the plain reference on the meta device at the cell's shapes, the
forward and the backward (the frozen nets' data gradient only), no
recomputation.

An InstanceNorm launch normalizes every (sample, channel) plane of an
(n, h, w, c) activation. The forward that keeps what the backward needs
reads x and writes y and rstd (n, c); the backward reads dy, y and rstd
and writes dx. Bytes count each of these once, activations in bfloat16
and rstd in float32. Operations per element: the forward's sum (1), the
centred square and its sum (3) and the normalization (2); the backward's
two sums (1 + 2) and ``rstd * (dy - mean(dy) - y * mean(dy * y))`` (4).
They run on the CUDA cores in float32, so a launch's bound is
max(bytes / HBM peak, operations / float32 peak).
"""

from __future__ import annotations

from typing import List

import torch

from . import counts, nets, train
from .counts import Launch
from .resnet_gen import Nets, generator, spec_of

ACT_BYTES = 2           # bfloat16 activations
STAT_BYTES = 4          # float32 rstd
FWD_FLOPS = 6           # a forward's operations per element
BWD_FLOPS = 7           # a backward's


def norm_launch(n: int, h: int, w: int, c: int, backward: bool = False
                ) -> Launch:
    """The work of one launch on an (n, h, w, c) activation."""
    elems = n * h * w * c
    if backward:
        return Launch("norm_bwd", BWD_FLOPS * elems,
                      3 * elems * ACT_BYTES + n * c * STAT_BYTES)
    return Launch("norm_fwd", FWD_FLOPS * elems,
                  2 * elems * ACT_BYTES + n * c * STAT_BYTES)


def forward_shapes(config: dict, batch: int) -> List[tuple]:
    """(n, h, w, c) of each InstanceNorm of one generator forward, in
    order."""
    h, w = config["image_hw"]
    gen = counts.meta_params(spec_of(config))
    x = torch.empty((batch, h, w, config["n_channels"]), device="meta")
    shapes: List[tuple] = []
    generator(gen, x, norm_rec=lambda *s: shapes.append(s))
    return shapes


def step_norm_launches(config: dict, traffic: dict) -> List[Launch]:
    """The InstanceNorm launches of one train step: a forward that keeps y
    and rstd for each norm of the generator, and a backward for each."""
    shapes = forward_shapes(config, traffic["batch"])
    return ([norm_launch(*s) for s in shapes]
            + [norm_launch(*s, backward=True) for s in shapes])


def step_flops(config: dict, traffic: dict) -> int:
    """Model FLOPs of one train step at the cell's batch."""
    b, hw = traffic["batch"], tuple(config["image_hw"])
    gen = counts.meta_params(spec_of(config))
    for v in gen.values():
        v.requires_grad_(True)
    nt = Nets(gen, counts.meta_params(nets.hned_spec()),
              counts.meta_params(nets.vgg_spec()))
    imgs = torch.empty((b, 3) + hw + (3,), device="meta")
    segs = torch.zeros((b, 3) + hw, dtype=torch.long, device="meta")

    def step():
        loss = train.triplet_loss(nt, imgs, segs, False,
                                  config["loss_weights"])
        torch.autograd.grad(loss.sum(), list(gen.values()))
    return counts.model_flops(step)
