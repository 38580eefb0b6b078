"""The reference's ResNet-9 generator as plain float32 functions of a
parameter dict, and the train step's nets around it.

Written from the published net (Johnson et al. 2016, ``resnet_9blocks`` of
junyanz/pytorch-CycleGAN-and-pix2pix ``models/networks.py``) with the two
heads of gongaa/video-layout-generation ``src/models/networks.py:370-381``,
and not from the port:

- a reflect-padded 7 x 7 stem, two stride-2 3 x 3 convs (zero padding 1),
  each conv followed by a non-affine InstanceNorm and a ReLU;
- ``n_blocks`` residual blocks ``x + IN(conv(pad(ReLU(IN(conv(pad(x)))))))``
  with reflect padding 1;
- two stride-2 transposed convs (padding 1, output padding 1), each
  followed by InstanceNorm and ReLU;
- two reflect-padded 7 x 7 heads: tanh RGB and the layout logits.

InstanceNorm is the mean and biased variance of each (sample, channel)
plane, ``(x - mean) / sqrt(var + EPS)``. Every conv has a bias.

Parameters are named as the port's ``state_dict`` names them (flax's
auto-names: ``Conv_0`` ... ``Conv_2``, ``ResnetBlock_i.Conv_j``,
``ConvTranspose_i``, ``last_conv_img``, ``last_conv_seg``), kernels in
flax's layout (kh, kw, Ci, Co). A transposed conv's kernel is applied as
flax applies it, without the spatial flip that a PyTorch transposed conv
implies, so it is flipped on its way to ``F.conv_transpose2d``.

Departures from the published net, each the train step's: no dropout (the
step runs the generator with ``train=False``, as the JAX step does); the
input has 10 channels (two frames, two layouts, two HED edge maps) and the
seg head 20 classes.

Two hooks, as in ``nets.py``: ``q`` is applied to the input and the kernel
of every convolution (the control's rounding); ``norm_rec(n, h, w, c)`` is
called once for each InstanceNorm, in the order of the forward
(``resnet_counts.py`` turns these into the kernels' launches).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import train

Params = Dict[str, torch.Tensor]

EPS = 1e-5      # nn.InstanceNorm2d's default, as in the published net


def _conv_spec(prefix: str, k: int, cin: int, cout: int) -> list:
    return [(f"{prefix}.kernel", (k, k, cin, cout), "kernel"),
            (f"{prefix}.bias", (cout,), "bias")]


def resnet_spec(n_in: int, ngf: int, n_blocks: int, img_out: int = 3,
                seg_out: int = 20) -> list:
    """(name, shape, kind) of every parameter, in the port's order."""
    d = 4 * ngf
    spec = (_conv_spec("Conv_0", 7, n_in, ngf)
            + _conv_spec("Conv_1", 3, ngf, 2 * ngf)
            + _conv_spec("Conv_2", 3, 2 * ngf, d))
    for i in range(n_blocks):
        spec += (_conv_spec(f"ResnetBlock_{i}.Conv_0", 3, d, d)
                 + _conv_spec(f"ResnetBlock_{i}.Conv_1", 3, d, d))
    spec += (_conv_spec("ConvTranspose_0", 3, d, 2 * ngf)
             + _conv_spec("ConvTranspose_1", 3, 2 * ngf, ngf)
             + _conv_spec("last_conv_img", 7, ngf, img_out)
             + _conv_spec("last_conv_seg", 7, ngf, seg_out))
    return spec


def spec_of(config: dict) -> list:
    return resnet_spec(config["n_channels"], config["ngf"],
                       config["n_blocks"], config["img_out"],
                       config["seg_out"])


class _Gen:
    def __init__(self, p: Params, q=None, norm_rec: Optional[Callable] = None):
        self.p, self.q, self.norm_rec = p, q, norm_rec

    def conv(self, x, name, stride=1, padding=0):
        w = self.p[f"{name}.kernel"].permute(3, 2, 0, 1)
        if self.q is not None:
            x, w = self.q(x), self.q(w)
        return F.conv2d(x, w, self.p[f"{name}.bias"], stride=stride,
                        padding=padding)

    def conv_transpose(self, x, name):
        # (kh, kw, Ci, Co) applied unflipped: PyTorch's (Ci, Co, kh, kw)
        # flipped in space
        w = self.p[f"{name}.kernel"].flip(0, 1).permute(2, 3, 0, 1)
        if self.q is not None:
            x, w = self.q(x), self.q(w)
        return F.conv_transpose2d(x, w, self.p[f"{name}.bias"], stride=2,
                                  padding=1, output_padding=1)

    def norm(self, x):
        if self.norm_rec is not None:
            n, c, h, w = x.shape
            self.norm_rec(n, h, w, c)
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).pow(2).mean(dim=(2, 3), keepdim=True)
        return (x - mean) / torch.sqrt(var + EPS)


def reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


def generator(p: Params, x_nhwc: torch.Tensor, q=None, norm_rec=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) -> (seg logits (N, seg_out, H, W), img (N, 3, H, W)
    in [-1, 1])."""
    g = _Gen(p, q, norm_rec)
    y = x_nhwc.permute(0, 3, 1, 2)
    y = torch.relu(g.norm(g.conv(reflect(y, 3), "Conv_0")))
    y = torch.relu(g.norm(g.conv(y, "Conv_1", stride=2, padding=1)))
    y = torch.relu(g.norm(g.conv(y, "Conv_2", stride=2, padding=1)))
    i = 0
    while f"ResnetBlock_{i}.Conv_0.kernel" in p:
        b = f"ResnetBlock_{i}"
        h = torch.relu(g.norm(g.conv(reflect(y, 1), f"{b}.Conv_0")))
        y = y + g.norm(g.conv(reflect(h, 1), f"{b}.Conv_1"))
        i += 1
    y = torch.relu(g.norm(g.conv_transpose(y, "ConvTranspose_0")))
    y = torch.relu(g.norm(g.conv_transpose(y, "ConvTranspose_1")))
    y = reflect(y, 3)
    return g.conv(y, "last_conv_seg"), torch.tanh(g.conv(y, "last_conv_img"))


class Nets(train.Nets):
    """``train.Nets`` with the ResNet generator in GridNet's place:
    ``train.terms`` calls the generator through ``gridnet``."""

    def gridnet(self, x):
        return generator(self.gen, x, self.q)


def follow(gen: Params, hned: Params, vgg: Params, batches, lr: float,
           b1: float, block: int, q=None) -> dict:
    """The reference's steps of ``batches`` from the initial weights
    (float32, TF32 off; ``q``: the control's rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = {k: v.detach().clone().float() for k, v in gen.items()}
    return train.follow_steps(Nets(gen, hned, vgg, q=q), batches, lr, b1,
                              block)
