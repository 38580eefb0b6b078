"""Convolutions and paddings of the pix2pix nets and the layout families
on NHWC activations.

The JAX package computes these with ``nn.Conv`` / ``nn.ConvTranspose``
outside any hand-written kernel, so here they are ``F.conv2d`` /
``F.conv_transpose2d`` under autograd. Parameters keep flax's names and
layout (``kernel`` (kh, kw, Ci, Co), ``bias`` (Co,)), stay f32 and are cast
to the activation dtype per call. An NHWC-contiguous tensor viewed as NCHW
is ``channels_last``; the kernels are handed over in that format too, so
the library stays on it and the result, viewed back as NHWC, is contiguous
with no copy before the InstanceNorm kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class _ParamCast(torch.autograd.Function):
    """``p.to(dtype)`` whose backward casts the gradient into a contiguous
    tensor, as the parameter is, where autograd's cast keeps the layout of
    the library's weight gradient: the optimizer's grouped calls
    (``train/state.py``) take a tensor in their launches only where its
    gradient is laid out as the tensor is, else one launch a call."""

    @staticmethod
    def forward(ctx, p, dtype):
        ctx.dtype = p.dtype
        return p.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=torch.contiguous_format), None


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The differentiable cast of a (contiguous) parameter to ``dtype``,
    its gradient contiguous (``_ParamCast``); a plain ``to`` where no
    gradient flows or the dtype is the parameter's."""
    if p.dtype == dtype or not (torch.is_grad_enabled() and p.requires_grad):
        return p.to(dtype)
    return _ParamCast.apply(p, dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding,
    kernel_dilation)`` with symmetric zero padding ``padding`` (0 is flax's
    VALID)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 kernel_init: Optional[Callable] = None, generator=None,
                 dilation: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        shape = (k, k, cin, cout)
        if kernel_init is None:
            value = torch.randn(shape, generator=generator) / (
                k * k * cin) ** 0.5
        else:
            value = kernel_init(shape, generator)
        self.kernel = nn.Parameter(value)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (Co, kh, kw, Ci) in memory, viewed (Co, Ci, kh, kw): channels_last
        w = cast_param(self.kernel, x.dtype).permute(
            3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.stride,
                     padding=self.padding, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(2, 2))`` in its
    three paddings:

    - k = 3, flax padding ((1, 2), (1, 2)): torch's ``padding=1,
      output_padding=1``;
    - k = 4, flax ``"SAME"``: ``padding=1``;
    - k = 3, flax ``"SAME"`` (``crop=1``): flax pads the dilated input
      (2, 1), where torch's ``padding=1, output_padding=1`` pads (1, 2), so
      it is ``padding=0`` with the last row and column of the 2H+1 x 2W+1
      result cropped away.

    flax applies the kernel without the spatial flip that torch's
    transposed conv implies, so the kernel is flipped on its way to the
    library; the parameter itself keeps flax's layout and orientation, and
    gradients and optimizer state are in that layout too."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 2,
                 padding: int = 1, output_padding: int = 0,
                 use_bias: bool = True,
                 kernel_init: Optional[Callable] = None, generator=None,
                 crop: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding, self.crop = output_padding, crop
        shape = (k, k, cin, cout)
        if kernel_init is None:
            value = torch.randn(shape, generator=generator) / (
                k * k * cin) ** 0.5
        else:
            value = kernel_init(shape, generator)
        self.kernel = nn.Parameter(value)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (Ci, kh, kw, Co) in memory, viewed (Ci, Co, kh, kw)
        w = cast_param(self.kernel, x.dtype).flip(0, 1).permute(
            2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b,
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y.permute(0, 2, 3, 1)


def pad2(x: torch.Tensor, p: int, padding_type: str = "reflect"
         ) -> torch.Tensor:
    """Pad H and W of NHWC ``x`` by ``p``: ``reflect`` (the edge pixel is not
    repeated), ``replicate`` or ``zero``. Written with slices and ``cat`` so
    that the result is NHWC-contiguous; torch's reflection pad works on the
    last two dimensions and would hand back NCHW."""
    if padding_type == "zero":
        return F.pad(x, (0, 0, p, p, p, p))
    if padding_type not in ("reflect", "replicate"):
        raise NotImplementedError(
            f"padding [{padding_type}] is not implemented")
    for dim in (1, 2):
        n = x.shape[dim]
        if padding_type == "reflect":
            lo = x.narrow(dim, 1, p).flip(dim)
            hi = x.narrow(dim, n - 1 - p, p).flip(dim)
        else:
            shape = [-1] * 4
            shape[dim] = p
            lo = x.narrow(dim, 0, 1).expand(shape)
            hi = x.narrow(dim, n - 1, 1).expand(shape)
        x = torch.cat([lo, x, hi], dim=dim)
    return x
