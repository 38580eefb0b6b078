"""The work of a step or a request: model FLOPs, and the operations and
bytes of each launch of the port's 3 x 3 conv kernels.

Model FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference on the meta device at the cell's shapes: the
convolutions and matrix products of the forward pass and, for training,
of the backward pass (the frozen nets' data gradient only). No
recomputation is counted: the reference keeps every activation.

A launch of kernel A computes one 3 x 3 convolution (PReLU before it,
bias, residual and ReLU after it fused); one of kernel B computes both
convolutions of a channel-preserving lateral block, its intermediate
kept on chip. Operations are 2 x N x Ho x Wo x Ci x Co x 9 a conv. Bytes
count each input, weight, bias, slope, residual and output once, in the
dtype the kernels read them: bfloat16 activations and kernels, float32
biases and slopes. B's intermediate is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import nets

ACT_BYTES = 2       # bfloat16 activations, kernels and residuals
PARAM_BYTES = 4     # float32 biases and PReLU slopes


@dataclass(frozen=True)
class Launch:
    kind: str       # "A" or "B"
    flops: int
    bytes: int


def conv_flops(n: int, ho: int, wo: int, ci: int, co: int) -> int:
    return 2 * n * ho * wo * ci * co * 9


def launch(kind: str, n: int, h: int, w: int, ci: int, co: int,
           stride: int = 1, residual: bool = False,
           transposed: bool = False) -> Launch:
    """The work of one launch on an (n, h, w, ci) input. ``transposed``:
    kernel A's launch for the data gradient of a conv from ``ci`` to
    ``co`` channels, which reads the gradient (co channels) and writes
    ci."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x_in, x_out = (co, ci) if transposed else (ci, co)
    act = n * h * w * x_in + n * ho * wo * x_out * (2 if residual else 1)
    if kind == "A":
        flops = conv_flops(n, ho, wo, ci, co)
        par = 9 * ci * co * ACT_BYTES + co * PARAM_BYTES + PARAM_BYTES
    elif kind == "B":
        flops = 2 * conv_flops(n, ho, wo, ci, co)
        par = 2 * (9 * ci * co * ACT_BYTES + co * PARAM_BYTES + PARAM_BYTES)
    else:
        raise ValueError(f"unknown kernel {kind!r}")
    return Launch(kind, flops, act * ACT_BYTES + par)


def recorded(fn: Callable, transposed: bool = False) -> List[Launch]:
    """The launches that ``fn(rec)`` records (``nets.py``'s hook)."""
    out: List[Launch] = []

    def rec(kind, n, h, w, ci, co, stride, residual):
        out.append(launch(kind, n, h, w, ci, co, stride, residual,
                          transposed))

    fn(rec)
    return out


def model_flops(fn: Callable) -> int:
    """FLOPs of ``fn()`` (run on meta tensors)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def meta_params(spec) -> dict:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in spec}


def net_launches(config: dict, batch: int) -> Dict[str, List[Launch]]:
    """The launches of one forward of each net at a configuration's
    shapes: the generator (``gen``), HED (``hned``), the VGG19 trunk
    (``vgg``), and the data gradient of the VGG19 trunk (``vgg_dgrad``)."""
    h, w = config["image_hw"]
    gen = meta_params(nets.gridnet_spec(config["n_channels"],
                                        config["filters_level"],
                                        config["arch"] == "CoordGridNet"))
    x = torch.empty((batch, h, w, config["n_channels"]), device="meta")
    hp, vp = meta_params(nets.hned_spec()), meta_params(nets.vgg_spec())
    rgb = torch.empty((batch, h, w, 3), device="meta")
    img = torch.empty((batch, 3, h, w), device="meta")
    vgg = lambda rec: nets.vgg_features(vp, img, rec=rec)  # noqa: E731
    return {"gen": recorded(lambda rec: nets.gridnet(gen, x, rec=rec)),
            "hned": recorded(lambda rec: nets.hned_edge(hp, rgb, rec=rec)),
            "vgg": recorded(vgg), "vgg_dgrad": recorded(vgg, transposed=True)}
