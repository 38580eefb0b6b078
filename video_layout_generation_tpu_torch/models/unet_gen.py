"""Recursive U-Net generator, pix2pix flavour (the JAX package's
``models/unet_gen.py``): ``num_downs`` nested skip levels of 4x4 stride-2
convs down (LeakyReLU 0.2) and 4x4 stride-2 transposed convs up (ReLU), the
skip concatenated on the channels, tanh output. NHWC; returns one tensor.

flax names every level ``UnetSkipBlock_i`` under the generator, innermost
first, so the levels are held flat here under those names and the recursion
is a loop over them. Forward and construction only: it is not an arch of
the train step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .init import get_initializer
from .layers import Conv, ConvTranspose
from .norms import get_norm_layer, norm_uses_bias


class UnetSkipBlock(nn.Module):
    """One level: ``down`` before the inner levels, ``up`` after them."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch",
                 use_dropout: bool = False, kernel_init=None, generator=None):
        super().__init__()
        self.outermost, self.innermost = outermost, innermost
        self.use_dropout = use_dropout
        bias = norm_uses_bias(norm)
        kw = dict(kernel_init=kernel_init, generator=generator)
        cin = outer_nc if input_nc is None else input_nc
        self.downconv = Conv(cin, inner_nc, 4, stride=2, padding=1,
                             use_bias=bias or outermost, **kw)
        self.upconv = ConvTranspose(
            inner_nc if innermost else inner_nc * 2, outer_nc, 4, padding=1,
            use_bias=bias or outermost, **kw)
        make_norm = get_norm_layer(norm)
        if not outermost:
            self.upnorm = make_norm(outer_nc)
            if not innermost:
                self.downnorm = make_norm(inner_nc)

    def down(self, x, train: bool):
        if self.outermost:
            return self.downconv(x)
        y = self.downconv(F.leaky_relu(x, 0.2))
        return y if self.innermost else self.downnorm(y, train)

    def up(self, x, y, train: bool):
        """``x`` the level's input (the skip), ``y`` what came back up."""
        y = self.upconv(F.relu(y))
        if self.outermost:
            return torch.tanh(y.float())
        y = self.upnorm(y, train)
        if self.use_dropout and not self.innermost and train:
            y = F.dropout(y, 0.5, True)
        return torch.cat([x, y], dim=-1)


class UnetGenerator(nn.Module):
    """``num_downs=8`` takes 256x256 down to 1x1, 7 takes 128x128."""

    def __init__(self, input_nc: int = 8, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False, init_type: str = "normal",
                 init_gain: float = 0.02,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        g = generator or torch.Generator().manual_seed(0)
        kw = dict(norm=norm, kernel_init=get_initializer(init_type,
                                                         init_gain),
                  generator=g)
        blocks = [UnetSkipBlock(ngf * 8, ngf * 8, innermost=True, **kw)]
        for _ in range(num_downs - 5):
            blocks.append(UnetSkipBlock(ngf * 8, ngf * 8,
                                        use_dropout=use_dropout, **kw))
        for mult in (4, 2, 1):
            blocks.append(UnetSkipBlock(ngf * mult, ngf * mult * 2, **kw))
        blocks.append(UnetSkipBlock(output_nc, ngf, input_nc=input_nc,
                                    outermost=True, **kw))
        self.n_levels = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"UnetSkipBlock_{i}", blk)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        levels = [self._modules[f"UnetSkipBlock_{i}"]
                  for i in reversed(range(self.n_levels))]   # outermost first
        skips = []
        for blk in levels:
            skips.append(x)
            x = blk.down(x, train)
        for blk in reversed(levels):
            x = blk.up(skips.pop(), x, train)
        return x
