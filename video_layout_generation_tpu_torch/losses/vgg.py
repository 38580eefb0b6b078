"""VGG19 perceptual feature loss (the JAX package's ``losses/vgg.py``).

A frozen VGG19 trunk truncated at relu4_4 and the L1 distance in its
feature space. The weights are an external ``.npz`` (``conv{b}_{j}.kernel``
in HWIO, ``conv{b}_{j}.bias``); with none the trunk is He-initialized from a
seed, which keeps the loss well defined.

Each of the 12 conv -> ReLU layers is one launch of kernel A
(``prelu_conv3x3`` with ``relu_out``); the 2x2 max pools are torch calls and
the L1 reduction is f32. Under autograd the gradient with respect to the
output image runs back through 12 more launches of kernel A (its data
gradient); the weights are frozen.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..io.weights import params_from_flax
from ..models.blocks import Conv3x3
from ..ops.pooling import max_pool_2x2

# Conv widths per block up to relu4_4 (VGG19 configuration 'E', truncated).
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512))


class VGG19Features(nn.Module):
    """VGG19 trunk through relu4_4, NHWC. ``dtype`` is the activation dtype
    (None keeps the input's); parameters stay f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for b, widths in enumerate(_BLOCKS):
            for j, f in enumerate(widths):
                self.add_module(f"conv{b+1}_{j+1}", Conv3x3(cin, f))
                cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous()
        for b, widths in enumerate(_BLOCKS):
            if b > 0:
                x = max_pool_2x2(x)
            for j in range(len(widths)):
                x = self._modules[f"conv{b+1}_{j+1}"](x, relu_out=True)
        return x


def vgg_feature_loss(model: VGG19Features, output: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """L1 in relu4_4 feature space, reduced in f32. The target branch
    carries no gradient."""
    fo = model(output)
    with torch.no_grad():
        ft = model(target)
    return (fo.float() - ft.float()).abs().mean()


def load_vgg_params(path: str) -> dict:
    """State dict of ``VGG19Features`` from a converted ``.npz``."""
    raw = np.load(path)
    names = [f"conv{b+1}_{j+1}" for b, widths in enumerate(_BLOCKS)
             for j in range(len(widths))]
    return params_from_flax({f"{n}.{leaf}": raw[f"{n}.{leaf}"]
                             for n in names for leaf in ("kernel", "bias")})


def make_vgg_loss(vgg_weights: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None,
                  params: Optional[Mapping] = None, seed: int = 0
                  ) -> VGG19Features:
    """The frozen trunk for the perceptual loss: weights from the ``.npz``
    at ``vgg_weights``, or from ``params`` (a flax tree, its flat form or a
    state dict), or else He-normal kernels and zero biases drawn from a
    ``torch.Generator`` seeded with ``seed`` (not flax's init stream: parity
    runs carry the weights across)."""
    model = VGG19Features(dtype=dtype)
    if vgg_weights is not None:
        model.load_state_dict(load_vgg_params(vgg_weights), strict=True)
    elif params is not None:
        model.load_state_dict(params_from_flax(params), strict=True)
    else:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in model.children():
                fan_in = 9 * m.kernel.shape[2]
                m.kernel.copy_(torch.randn(m.kernel.shape, generator=g)
                               * math.sqrt(2.0 / fan_in))
                m.bias.zero_()
    return model.requires_grad_(False).eval()
