"""GridNet building blocks as torch modules (NHWC activations).

The counterparts of the JAX package's ``models/blocks.py``, with the flax
module and parameter names (``PReLU_0/alpha``, ``Conv_0/kernel``,
``Conv_0/bias``, ...) so that the weight bridge (io/weights.py) maps one to
one. Kernels are kept in flax's HWIO layout, which is the layout kernel A
and kernel B read.

Every 3x3 conv runs through the hand-written kernels: a channel-preserving
LateralBlock without shortcut is one launch of kernel B (``fused_lateral``),
every other conv one launch of kernel A (``prelu_conv3x3``) with the PReLU
before it fused in. A block takes the grid's additive fusion as
``residual`` and adds it in the last kernel's epilogue. Under
``ops.kernels.plain()`` the kernels' plain PyTorch versions run instead
(the on-card reference).

Training: with autograd on, a block hands the kernels its live biases and
PReLU slopes and, where the kernel requires grad, the differentiable cast
``kernel.to(dtype)`` (``layers.cast_param``: its gradient comes back
contiguous, as the kernel is); the kernels' autograd Functions then take every
gradient from the library's VJP (cuDNN on the card, in the activation
dtype; ``ops/kernels/conv3x3.py``, ``ops/kernels/lateral.py``), so the
forward stays kernels A and B. Without grad (serving, validation) or with a
frozen kernel (VGG19, whose data gradient is a launch of kernel A) the cast
is made once and kept until the parameter changes in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.coords import add_coord_channels
from ..ops.kernels import fused_lateral, prelu_conv3x3
from ..ops.kernels.conv3x3 import prelu_plain
from ..ops.resize import upsample2x
from .layers import cast_param


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Stand-alone scalar-alpha PReLU in x's dtype, where no conv follows
    directly to fuse it into (the Coord blocks append coordinates
    between the two)."""
    return prelu_plain(x, alpha).to(x.dtype)


class PReLU(nn.Module):
    """One shared slope, init 0.25 (torch nn.PReLU default)."""

    def __init__(self, init_value: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(float(init_value)))


class Conv3x3(nn.Module):
    """Parameters of one flax ``nn.Conv(features, (3, 3))``: ``kernel``
    (3, 3, Ci, Co) and ``bias`` (Co,), kept in f32."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.randn(3, 3, cin, cout) / math.sqrt(9 * cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._cast_key = None
        self._cast = None

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel in the activation dtype. With grad enabled and a
        kernel that requires grad, the differentiable cast, made anew each
        call; otherwise a detached cast, made once and kept until the
        parameter changes (its version counter moves: an optimizer's
        in-place update)."""
        if torch.is_grad_enabled() and self.kernel.requires_grad:
            return cast_param(self.kernel, dtype)
        k = self.kernel.detach()
        if k.dtype == dtype:
            return k
        key = (dtype, k.device, k.data_ptr(), k._version)
        if self._cast_key != key:
            # a normal tensor even when a rollout under inference_mode asks
            # first: it has a version counter (the kernels' weight-pack cache
            # reads it) and can be saved for a backward
            with torch.inference_mode(False):
                self._cast = self.kernel.detach().to(dtype).contiguous()
            self._cast_key = key
        return self._cast

    def forward(self, x: torch.Tensor, alpha: Optional[nn.Parameter] = None,
                residual: Optional[torch.Tensor] = None, stride: int = 1,
                relu_out: bool = False) -> torch.Tensor:
        return prelu_conv3x3(x, self.weight(x.dtype), self.bias, alpha,
                             residual, stride, relu_out)


class LateralBlock(nn.Module):
    """PReLU -> conv -> PReLU -> conv, optional conv shortcut."""

    def __init__(self, cin: int, out_ch: int, shortcut_conv: bool = False):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.Conv_0 = Conv3x3(cin, out_ch)
        self.PReLU_1 = PReLU()
        self.Conv_1 = Conv3x3(out_ch, out_ch)
        if shortcut_conv:
            self.Conv_2 = Conv3x3(cin, out_ch)
        self.fused = not shortcut_conv and cin == out_ch

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused:
            c0, c1 = self.Conv_0, self.Conv_1
            return fused_lateral(x, c0.weight(x.dtype), c0.bias,
                                 self.PReLU_0.alpha, c1.weight(x.dtype),
                                 c1.bias, self.PReLU_1.alpha, residual)
        s = residual
        if hasattr(self, "Conv_2"):
            s = self.Conv_2(x, residual=residual)
        y = self.Conv_0(x, self.PReLU_0.alpha)
        return self.Conv_1(y, self.PReLU_1.alpha, residual=s)


class DownSamplingBlock(nn.Module):
    """PReLU -> stride-2 conv -> PReLU -> conv."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.Conv_0 = Conv3x3(cin, out_ch)
        self.PReLU_1 = PReLU()
        self.Conv_1 = Conv3x3(out_ch, out_ch)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.Conv_0(x, self.PReLU_0.alpha, stride=2)
        return self.Conv_1(y, self.PReLU_1.alpha, residual=residual)


class UpSamplingBlock(nn.Module):
    """x2 upsample (align-corners bilinear, or nearest in the rollout's
    opt-in mode) -> PReLU -> conv -> PReLU -> conv."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.Conv_0 = Conv3x3(cin, out_ch)
        self.PReLU_1 = PReLU()
        self.Conv_1 = Conv3x3(out_ch, out_ch)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                upsample: str = "bilinear") -> torch.Tensor:
        y = self.Conv_0(upsample2x(x, upsample), self.PReLU_0.alpha)
        return self.Conv_1(y, self.PReLU_1.alpha, residual=residual)


class CoordConv(nn.Module):
    """Conv over the input with two coordinate channels appended."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = Conv3x3(cin + 2, cout)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None, stride: int = 1
                ) -> torch.Tensor:
        return self.Conv_0(add_coord_channels(x), residual=residual,
                           stride=stride)


class CoordLateralBlock(nn.Module):
    """coordconv -> PReLU -> coordconv, optional coordconv shortcut (no
    leading PReLU)."""

    def __init__(self, cin: int, out_ch: int, shortcut_conv: bool = False):
        super().__init__()
        self.CoordConv_0 = CoordConv(cin, out_ch)
        self.PReLU_0 = PReLU()
        self.CoordConv_1 = CoordConv(out_ch, out_ch)
        if shortcut_conv:
            self.CoordConv_2 = CoordConv(cin, out_ch)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = residual
        if hasattr(self, "CoordConv_2"):
            s = self.CoordConv_2(x, residual=residual)
        y = prelu(self.CoordConv_0(x), self.PReLU_0.alpha)
        return self.CoordConv_1(y, residual=s)


class CoordDownSamplingBlock(nn.Module):
    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.CoordConv_0 = CoordConv(cin, out_ch)
        self.PReLU_1 = PReLU()
        self.CoordConv_1 = CoordConv(out_ch, out_ch)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.CoordConv_0(prelu(x, self.PReLU_0.alpha), stride=2)
        return self.CoordConv_1(prelu(y, self.PReLU_1.alpha),
                                residual=residual)


class CoordUpSamplingBlock(nn.Module):
    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.PReLU_0 = PReLU()
        self.CoordConv_0 = CoordConv(cin, out_ch)
        self.PReLU_1 = PReLU()
        self.CoordConv_1 = CoordConv(out_ch, out_ch)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                upsample: str = "bilinear") -> torch.Tensor:
        y = prelu(upsample2x(x, upsample), self.PReLU_0.alpha)
        y = self.CoordConv_0(y)
        return self.CoordConv_1(prelu(y, self.PReLU_1.alpha),
                                residual=residual)
