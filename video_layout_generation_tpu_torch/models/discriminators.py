"""GAN discriminators (the JAX package's ``models/discriminators.py``).

- ``NLayerDiscriminator``: 70x70 PatchGAN, a 4x4 stride-2 conv ladder with
  LeakyReLU(0.2) and norm, a stride-1 tail and 1-channel patch logits.
- ``PixelDiscriminator``: 1x1-conv per-pixel classifier.

NHWC, logits f32. Module names follow flax (``Conv_0`` ...,
``BatchNorm_0`` ...). With ``norm="instance"`` each norm layer is a launch
of the InstanceNorm kernel on the card (``n_layers`` per forward of the
PatchGAN); the convs are library calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .init import get_initializer
from .layers import Conv
from .norms import get_norm_layer, norm_name, norm_uses_bias


class _Discriminator(nn.Module):
    def _add_norms(self, norm: str, channels) -> None:
        self.norm = norm
        self.norm_names = [f"{norm_name(norm)}_{i}"
                           for i in range(len(channels))]
        for name, ch in zip(self.norm_names, channels):
            self.add_module(name, get_norm_layer(norm)(ch))

    def _norm(self, i: int, x, train, update_stats):
        y = self._modules[self.norm_names[i]](x, train, update_stats)
        return F.leaky_relu(y, 0.2)


class NLayerDiscriminator(_Discriminator):
    def __init__(self, input_nc: int = 9, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", init_type: str = "normal",
                 init_gain: float = 0.02,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        g = generator or torch.Generator().manual_seed(0)
        kw = dict(padding=1, kernel_init=get_initializer(init_type, init_gain),
                  generator=g)
        bias = norm_uses_bias(norm)
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        self.Conv_0 = Conv(input_nc, ndf, 4, stride=2, **kw)
        for n in range(1, n_layers + 1):
            self.add_module(f"Conv_{n}", Conv(
                widths[n - 1], widths[n], 4,
                stride=2 if n < n_layers else 1, use_bias=bias, **kw))
        self.add_module(f"Conv_{n_layers + 1}",
                        Conv(widths[-1], 1, 4, stride=1, **kw))
        self._add_norms(norm, widths[1:])

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """x (N, H, W, input_nc) -> patch logits (N, h, w, 1) f32. ``train``
        and ``update_stats`` matter to a BatchNorm discriminator only."""
        # the ladder halves the size n_layers times, then shaves a pixel
        # twice: a smaller input would leave a patch map of size zero
        min_hw = 3 * (2 ** self.n_layers)
        if min(x.shape[1], x.shape[2]) < min_hw:
            raise ValueError(
                f"NLayerDiscriminator(n_layers={self.n_layers}) needs "
                f"input >= {min_hw}px; got {x.shape[1]}x{x.shape[2]}")
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = F.leaky_relu(self.Conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            y = self._norm(n - 1, self._modules[f"Conv_{n}"](y), train,
                           update_stats)
        return self._modules[f"Conv_{self.n_layers + 1}"](y).float()


class PixelDiscriminator(_Discriminator):
    def __init__(self, input_nc: int = 9, ndf: int = 64,
                 norm: str = "instance", init_type: str = "normal",
                 init_gain: float = 0.02,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        g = generator or torch.Generator().manual_seed(0)
        kw = dict(kernel_init=get_initializer(init_type, init_gain),
                  generator=g)
        bias = norm_uses_bias(norm)
        self.Conv_0 = Conv(input_nc, ndf, 1, **kw)
        self.Conv_1 = Conv(ndf, ndf * 2, 1, use_bias=bias, **kw)
        self.Conv_2 = Conv(ndf * 2, 1, 1, use_bias=bias, **kw)
        self._add_norms(norm, [ndf * 2])

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = F.leaky_relu(self.Conv_0(x), 0.2)
        y = self._norm(0, self.Conv_1(y), train, update_stats)
        return self.Conv_2(y).float()
