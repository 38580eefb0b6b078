"""ResNet-based generator with segmentation and image heads (the JAX
package's ``models/resnet_gen.py``).

Reflect-padded 7x7 stem, two stride-2 downsampling convs, ``n_blocks``
residual blocks, two transposed-conv upsampling stages, then two 7x7 heads:
tanh RGB (3 channels) and segmentation logits (20). Returns ``(seg, img)``.
Module names follow flax's auto-naming (``Conv_0`` ... ``Conv_2``,
``ResnetBlock_i/Conv_0``, ``ConvTranspose_0``, ``last_conv_img``, ...), so
the weight bridge maps one to one.

With ``norm="instance"`` every norm layer is a launch of the hand-written
InstanceNorm kernel on the card: 5 + 2 * n_blocks per forward (23 at 9
blocks), and as many launches of its backward kernel per backward. The
convs are library calls, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate
from .init import get_initializer
from .layers import Conv, ConvTranspose, pad2
from .norms import get_norm_layer, norm_name, norm_uses_bias


class ResnetBlock(nn.Module):
    """x + norm(conv(pad(relu(norm(conv(pad(x)))))))."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "instance", use_dropout: bool = False,
                 kernel_init=None, generator=None):
        super().__init__()
        self.padding_type = padding_type
        self.use_dropout = use_dropout
        bias = norm_uses_bias(norm)
        self.Conv_0 = Conv(dim, dim, 3, use_bias=bias,
                           kernel_init=kernel_init, generator=generator)
        self.Conv_1 = Conv(dim, dim, 3, use_bias=bias,
                           kernel_init=kernel_init, generator=generator)
        self.norm_names = [f"{norm_name(norm)}_{i}" for i in range(2)]
        for name in self.norm_names:
            self.add_module(name, get_norm_layer(norm)(dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        n0, n1 = (self._modules[k] for k in self.norm_names)
        y = self.Conv_0(pad2(x, 1, self.padding_type))
        y = F.relu(n0(y, train))
        if self.use_dropout and train:
            y = F.dropout(y, 0.5, True)
        y = self.Conv_1(pad2(y, 1, self.padding_type))
        return x + n1(y, train)


class ResnetGenerator(nn.Module):
    """``dtype`` is the activation dtype (None keeps the input's);
    parameters stay f32. ``generator`` seeds the initial weights (seed 0 when
    None)."""

    def __init__(self, input_nc: int = 8, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, seg_out: int = 20,
                 norm: str = "instance", use_dropout: bool = False,
                 padding_type: str = "reflect", init_type: str = "normal",
                 init_gain: float = 0.02,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.norm = norm
        self.n_blocks = n_blocks
        g = generator or torch.Generator().manual_seed(0)
        kinit = get_initializer(init_type, init_gain)
        bias = norm_uses_bias(norm)
        kw = dict(use_bias=bias, kernel_init=kinit, generator=g)
        make_norm, stem = get_norm_layer(norm), norm_name(norm)

        self.Conv_0 = Conv(input_nc, ngf, 7, **kw)
        self.Conv_1 = Conv(ngf, ngf * 2, 3, stride=2, padding=1, **kw)
        self.Conv_2 = Conv(ngf * 2, ngf * 4, 3, stride=2, padding=1, **kw)
        for i in range(n_blocks):
            self.add_module(f"ResnetBlock_{i}", ResnetBlock(
                ngf * 4, padding_type, norm, use_dropout, kinit, g))
        self.ConvTranspose_0 = ConvTranspose(ngf * 4, ngf * 2, 3, padding=1,
                                             output_padding=1, **kw)
        self.ConvTranspose_1 = ConvTranspose(ngf * 2, ngf, 3, padding=1,
                                             output_padding=1, **kw)
        self.last_conv_img = Conv(ngf, output_nc, 7, kernel_init=kinit,
                                  generator=g)
        self.last_conv_seg = Conv(ngf, seg_out, 7, kernel_init=kinit,
                                  generator=g)
        self.norm_names = [f"{stem}_{i}" for i in range(5)]
        for name, ch in zip(self.norm_names,
                            (ngf, ngf * 2, ngf * 4, ngf * 2, ngf)):
            self.add_module(name, make_norm(ch))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, H, W, input_nc) -> (seg logits f32, img f32 in [-1, 1])."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        norms = [self._modules[k] for k in self.norm_names]
        with annotate("gen.stem"):
            y = self.Conv_0(pad2(x, 3))
            y = F.relu(norms[0](y, train))
            y = F.relu(norms[1](self.Conv_1(y), train))
            y = F.relu(norms[2](self.Conv_2(y), train))
        with annotate("gen.blocks"):
            for i in range(self.n_blocks):
                y = self._modules[f"ResnetBlock_{i}"](y, train)
        with annotate("gen.up"):
            y = F.relu(norms[3](self.ConvTranspose_0(y), train))
            y = F.relu(norms[4](self.ConvTranspose_1(y), train))
            y = pad2(y, 3)
            img = torch.tanh(self.last_conv_img(y).float())
            seg = self.last_conv_seg(y).float()
        return seg, img
