"""HNED, the frozen holistically-nested edge detector (the JAX package's
``models/hned.py``).

A VGG16-style 5-stage trunk, five 1x1 side-score convs, a bilinear resize
of each score map back to the input resolution and a 1x1 fused combine with
sigmoid. Returns the 6-tuple ``(d1..d5, fuse)``; the pipeline consumes only
``fuse``.

Preprocessing happens inside ``forward``: caffe-style scaling to [0, 255]
and BGR mean subtraction. The network was trained on BGR input, so RGB is
flipped to BGR first; ``assume_bgr_input=True`` feeds the channels as they
come.

Each of the 13 conv -> ReLU layers of the trunk is one launch of kernel A
(``prelu_conv3x3`` with ``relu_out``). The 1x1 convs, the max pools and the
resizes are torch calls, the score maps and their resizes f32. Module names
follow flax (``vgg1_0`` ... ``vgg5_2``, ``score1`` ... ``score5``,
``combine``), so the weight bridge maps one to one. Frozen: no parameter is
ever updated.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.pooling import max_pool_2x2
from ..ops.resize import resize_bilinear
from ..train.assemble import const_like
from .blocks import Conv3x3

_CAFFE_MEANS_BGR = (104.00698793, 116.66876762, 122.67891434)
_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
           (512, 512, 512))


class Conv1x1(nn.Module):
    """Parameters of one flax ``nn.Conv(features, (1, 1))``: ``kernel``
    (1, 1, Ci, Co) and ``bias`` (Co,), applied as a matrix product in the
    activation dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.randn(1, 1, cin, cout) / math.sqrt(cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.detach().reshape(self.kernel.shape[2:]).to(x.dtype)
        return torch.matmul(x, k) + self.bias.detach().to(x.dtype)


class HNED(nn.Module):
    """``dtype`` is the activation dtype of the trunk (None keeps f32);
    parameters stay f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 assume_bgr_input: bool = False):
        super().__init__()
        self.dtype = dtype
        self.assume_bgr_input = assume_bgr_input
        cin = 3
        for b, widths in enumerate(_STAGES):
            for j, f in enumerate(widths):
                self.add_module(f"vgg{b+1}_{j}", Conv3x3(cin, f))
                cin = f
            self.add_module(f"score{b+1}", Conv1x1(cin, 1))
        self.combine = Conv1x1(len(_STAGES), 1)

    def forward(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """rgb (N, H, W, 3) in [0, 1] -> six f32 edge maps (N, H, W, 1)."""
        h, w = rgb.shape[1], rgb.shape[2]
        x = rgb.float() * 255.0
        if not self.assume_bgr_input:
            x = x.flip(-1)  # RGB -> BGR
        x = x - const_like(_CAFFE_MEANS_BGR, x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous()

        scores = []
        for b, widths in enumerate(_STAGES):
            if b > 0:
                x = max_pool_2x2(x)
            for j in range(len(widths)):
                x = self._modules[f"vgg{b+1}_{j}"](x, relu_out=True)
            s = self._modules[f"score{b+1}"](x).float()
            scores.append(resize_bilinear(s, (h, w), align_corners=False))

        fuse_in = torch.cat(scores, dim=-1)
        if self.dtype is not None:
            fuse_in = fuse_in.to(self.dtype)
        fuse = torch.sigmoid(self.combine(fuse_in).float())
        return tuple(torch.sigmoid(s) for s in scores) + (fuse,)


@torch.no_grad()
def hned_fused_edge(model: HNED, rgb: torch.Tensor) -> torch.Tensor:
    """The frozen fused edge map (N, H, W, 1), carrying no gradient."""
    return model(rgb)[-1]
