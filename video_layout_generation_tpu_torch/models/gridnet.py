"""GridNet / CoordGridNet as torch modules (the JAX package's
``models/gridnet.py``).

A 3-row x 6-column grid CNN: row r runs at 1/2^r of the input size with
widths ``filters_level``; columns 1-2 fuse lateral + downsampling paths
additively, columns 3-5 lateral + upsampling paths; two heads read row 0
(segmentation logits and RGB frame). Module names follow flax
(``lateral_in``, ``down_00``, ``col_{i}/lateral_0{i-1}``, ``up_0{i}``,
``lateral_out_seg``, ...), so the flax parameter tree maps one to one.

Each grid addition is handed to the lateral block as its ``residual`` and
lands in kernel B's epilogue. Per forward that makes 31 launches of kernel
A (lateral_in 3, down_00 and down_10 2 each, 4 per column, 2 per head) and
15 of kernel B (three in-grid laterals per column).

Training (``train/steps.py:make_train_step``, ``train/gan.py``): the forward
is the same 31 + 15 launches, once a step; the backward launches neither
kernel. Every gradient of A and B (activations, kernels, biases, PReLU
slopes, the residual that carries the grid's additions back to the down and
up blocks that made it) is the library's VJP, recomputed from the inputs
each Function saved (cuDNN in bf16 on the card; see
``ops/kernels/conv3x3.py``, ``ops/kernels/lateral.py``), as the JAX
package's Pallas kernels take ``jax.vjp`` of the XLA conv. The upsample,
the CoordConv stem's coordinate channels and its stand-alone PReLU are
torch ops under autograd. Parameters stay f32; the blocks hand the kernels
a differentiable bf16 cast of each kernel, so the f32 gradient is the bf16
one cast back, as in the JAX package's bf16 step.

``remat=True`` (the JAX package's ``nn.remat`` of each grid column) runs
every column through ``torch.utils.checkpoint`` when autograd is on: the
backward runs each column's forward again, 20 launches of A and 15 of B
more a step, and keeps only the columns' inputs alive in between.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import (CoordLateralBlock, DownSamplingBlock, LateralBlock,
                     UpSamplingBlock)

N_COL = 6


class _EncColumn(nn.Module):
    """Encoder column: lateral row 0, down + lateral rows 1 and 2."""

    def __init__(self, filters: Sequence[int], col: int):
        super().__init__()
        f0, f1, f2 = filters
        i = col
        self.add_module(f"lateral_0{i-1}", LateralBlock(f0, f0))
        self.add_module(f"down_0{i}", DownSamplingBlock(f0, f1))
        self.add_module(f"lateral_1{i-1}", LateralBlock(f1, f1))
        self.add_module(f"down_1{i}", DownSamplingBlock(f1, f2))
        self.add_module(f"lateral_2{i-1}", LateralBlock(f2, f2))
        self.col = col

    def forward(self, x0, x1, x2, upsample: str = "bilinear"):
        i, m = self.col, self._modules
        x0 = m[f"lateral_0{i-1}"](x0)
        x1 = m[f"lateral_1{i-1}"](x1, residual=m[f"down_0{i}"](x0))
        x2 = m[f"lateral_2{i-1}"](x2, residual=m[f"down_1{i}"](x1))
        return x0, x1, x2


class _DecColumn(nn.Module):
    """Decoder column: lateral row 2, up + lateral rows 1 and 0."""

    def __init__(self, filters: Sequence[int], col: int):
        super().__init__()
        f0, f1, f2 = filters
        i = col
        self.add_module(f"lateral_2{i-1}", LateralBlock(f2, f2))
        self.add_module(f"up_1{i}", UpSamplingBlock(f2, f1))
        self.add_module(f"lateral_1{i-1}", LateralBlock(f1, f1))
        self.add_module(f"up_0{i}", UpSamplingBlock(f1, f0))
        self.add_module(f"lateral_0{i-1}", LateralBlock(f0, f0))
        self.col = col

    def forward(self, x0, x1, x2, upsample: str = "bilinear"):
        i, m = self.col, self._modules
        x2 = m[f"lateral_2{i-1}"](x2)
        up1 = m[f"up_1{i}"](x2, upsample=upsample)
        x1 = m[f"lateral_1{i-1}"](x1, residual=up1)
        up0 = m[f"up_0{i}"](x1, upsample=upsample)
        x0 = m[f"lateral_0{i-1}"](x0, residual=up0)
        return x0, x1, x2


class GridNet(nn.Module):
    """3x6 grid CNN with segmentation and image heads.

    ``dtype`` is the activation dtype (None keeps the input's); parameters
    stay f32 and are cast to it for the kernels, differentiably when
    autograd is on. A forward is 31 launches of kernel A and 15 of kernel
    B; under training their backward is the library's (module docstring)."""

    def __init__(self, n_channels: int = 10, seg_out: int = 20,
                 img_out: int = 3,
                 filters_level: Sequence[int] = (32, 64, 96),
                 coord_in: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        f0, f1, f2 = filters_level
        self.dtype = dtype
        self.remat = remat
        lat_in = CoordLateralBlock if coord_in else LateralBlock
        self.lateral_in = lat_in(n_channels, f0, shortcut_conv=True)
        self.down_00 = DownSamplingBlock(f0, f1)
        self.down_10 = DownSamplingBlock(f1, f2)
        for i in range(1, N_COL):
            cls = _EncColumn if i < N_COL / 2 else _DecColumn
            self.add_module(f"col_{i}", cls(filters_level, i))
        self.lateral_out_seg = LateralBlock(f0, seg_out)
        self.lateral_out_img = LateralBlock(f0, img_out)

    def forward(self, x: torch.Tensor, upsample: str = "bilinear"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, H, W, n_channels) -> (seg logits, img), both f32 NHWC."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous()
        x0 = self.lateral_in(x)
        x1 = self.down_00(x0)
        x2 = self.down_10(x1)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(1, N_COL):
            col = self._modules[f"col_{i}"]
            if remat:
                # nothing random inside a column: no RNG state to replay
                x0, x1, x2 = checkpoint(col, x0, x1, x2, upsample=upsample,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                x0, x1, x2 = col(x0, x1, x2, upsample=upsample)
        seg = self.lateral_out_seg(x0)
        img = self.lateral_out_img(x0)
        return seg.float(), img.float()


def CoordGridNet(n_channels: int = 10, **kw) -> GridNet:
    """CoordConv input-stem variant."""
    return GridNet(n_channels=n_channels, coord_in=True, **kw)
