"""Legacy masked layout completion (the JAX package's ``models/legacy.py``),
on NHWC tensors.

- ``UNet``: the classic 4-down / 4-up U-Net with BatchNorm double convs; it
  masks the one-hot layout, predicts, and composites the prediction into
  the region its mask leaves out (reference src/models/u_net.py:96-132).
- ``EncoderDecoder``: a strided conv encoder, four dilated convs (d = 2, 4,
  8, 16), a bottleneck and a bilinear-upsampling decoder (reference
  src/models/encoder_decoder.py:7-70).
- ``Simple``: a class-id embedding (masked ids become a dedicated "cropped"
  class), the backbone, and the composite into the known region (reference
  src/models/simple.py:11-62). The loss is ``losses.ce.weighted_masked_ce``
  with ``SIMPLE29_CLASS_WEIGHTS``.

Every conv is the library's (``models/layers.py:Conv`` -> ``F.conv2d``), as
the JAX package's are flax convs in XLA: they run in f32 (``dtype=None``,
as ``val.py`` builds them), and take 5x5 and 1x1 kernels, strides and
dilations. The BatchNorm is the port's (``models/norms.py``): flax's
momentum 0.9 (0.1 here), epsilon 1e-5, the biased batch variance in
``train=True`` and the running statistics otherwise.

Module and parameter names are flax's (``layer.inc.conv0.kernel``, the
buffers ``layer.inc.bn0.mean`` / ``var``, EncoderDecoder's auto-named
``layer.Conv_0`` ... ``layer.Conv_16``, ``embedding.embedding``), so
``io/weights.py:params_from_flax`` maps a flax ``{"params", "batch_stats"}``
tree onto these modules as it is. ``Simple`` holds its embedding in
``u_net`` mode too, where nothing reads it, as the flax module creates it
before it branches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.one_hot import seg_one_hot
from ..ops.pooling import max_pool_2x2
from ..ops.resize import upsample2x_bilinear_align
from .layers import Conv
from .norms import BatchNorm

# Per-class CE weights for the 29-class completion task
# (reference src/models/simple.py:19).
SIMPLE29_CLASS_WEIGHTS = (
    0.19, 0.45, 0.29, 0.13, 0.2, 0.33, 0.48, 0.14, 0.36, 0.34, 1.0, 0.43,
    0.66, 0.33, 0.51, 0.41, 0.17, 0.31, 0.19, 0.33, 0.57, 0.21, 0.48, 0.49,
    0.75, 0.88, 0.49, 0.61, 0.42,
)


class DoubleConv(nn.Module):
    """(conv -> BN -> ReLU) x2 (reference src/models/u_net.py:7-22)."""

    def __init__(self, cin: int, out_ch: int, generator=None):
        super().__init__()
        for i in range(2):
            self.add_module(f"conv{i}", Conv(cin if i == 0 else out_ch,
                                             out_ch, 3, padding=1,
                                             generator=generator))
            self.add_module(f"bn{i}", BatchNorm(out_ch, momentum=0.1))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = self._modules[f"conv{i}"](x)
            x = F.relu(self._modules[f"bn{i}"](x, train=train))
        return x


class UNet(nn.Module):
    """``forward(img, seg, mask)``: ``mask == 1`` marks the known region,
    the composite is ``pred * (1 - mask) + seg * mask``; ``seg`` is the
    (N, H, W, n_classes) one-hot layout, ``img`` (N, H, W, n_channels).
    H and W must be divisible by 16."""

    def __init__(self, n_channels: int = 3, n_classes: int = 29,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        widths = (("inc", n_channels + n_classes, 64), ("down1", 64, 128),
                  ("down2", 128, 256), ("down3", 256, 512),
                  ("down4", 512, 512), ("up1", 1024, 256),
                  ("up2", 512, 128), ("up3", 256, 64), ("up4", 128, 64))
        for name, cin, cout in widths:
            self.add_module(name, DoubleConv(cin, cout, generator))
        self.outc = Conv(64, n_classes, 1, generator=generator)

    def forward(self, img: torch.Tensor, seg: torch.Tensor,
                mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        maskf = mask[..., None].float()
        seg_masked = seg * maskf
        x = torch.cat([img.float(), seg_masked], dim=-1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x1 = self.inc(x, train)
        x2 = self.down1(max_pool_2x2(x1), train)
        x3 = self.down2(max_pool_2x2(x2), train)
        x4 = self.down3(max_pool_2x2(x3), train)
        y = self.down4(max_pool_2x2(x4), train)
        for name, skip in (("up1", x4), ("up2", x3), ("up3", x2),
                           ("up4", x1)):
            y = torch.cat([skip, upsample2x_bilinear_align(y)], dim=-1)
            y = self._modules[name](y, train)
        y = self.outc(y).float()
        return y * (1.0 - maskf) + seg_masked


# (features, kernel, stride, dilation) of EncoderDecoder's convs, in order;
# every one but the last is followed by a ReLU, and the decoder upsamples
# 2x before Conv_12 and Conv_14
_ED_CONVS = ((32, 5, 1, 1), (64, 3, 2, 1), (64, 3, 1, 1), (128, 3, 2, 1),
             (128, 3, 1, 1), (128, 3, 1, 1), (128, 3, 1, 2), (128, 3, 1, 4),
             (128, 3, 1, 8), (128, 3, 1, 16), (128, 3, 1, 1),
             (128, 3, 1, 1), (128, 3, 1, 1), (128, 3, 1, 1), (64, 3, 1, 1),
             (64, 3, 1, 1))
_ED_UPSAMPLE_BEFORE = (12, 14)


class EncoderDecoder(nn.Module):
    """Dilated-conv encoder-decoder over an (N, H, W, n_channels) input ->
    (N, H, W, n_classes) f32 logits. H and W must be divisible by 4."""

    def __init__(self, n_channels: int = 15, n_classes: int = 29,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        cin = n_channels
        convs = _ED_CONVS + ((n_classes, 3, 1, 1),)
        for i, (cout, k, s, d) in enumerate(convs):
            self.add_module(f"Conv_{i}", Conv(cin, cout, k, stride=s,
                                              padding=d * (k // 2),
                                              dilation=d,
                                              generator=generator))
            cin = cout
        self.n_convs = len(convs)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(self.n_convs):
            if i in _ED_UPSAMPLE_BEFORE:
                x = upsample2x_bilinear_align(x)
            x = self._modules[f"Conv_{i}"](x)
            if i < self.n_convs - 1:
                x = F.relu(x)
        return x.float()


class Embed(nn.Module):
    """flax ``nn.Embed``: parameter ``embedding`` (num, features)."""

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(num, features, generator=generator) / features ** 0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class Simple(nn.Module):
    """Masked layout completion (reference src/models/simple.py:11-62).

    ``forward(mask, seg_gt, img=None, train=False)``: ``mask == 1`` marks
    the cropped region, to complete; ``seg_gt`` (N, H, W) holds class ids;
    ``img`` (N, H, W, 3) feeds the ``u_net`` backbone only. Returns
    (N, H, W, n_classes) f32 logits composited as the reference does:

    - ``u_net``: the UNet gets the known mask, ``1 - mask``, and keeps the
      one-hot ground truth there;
    - ``encoder_decoder``: ``pred * mask + one_hot(seg_gt)``, so the
      one-hot ground truth is added inside the cropped region too
      (reference simple.py:53).
    """

    def __init__(self, n_classes: int = 29,
                 embedding_dim: Optional[int] = 15,
                 model_name: str = "u_net",
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        if model_name not in ("u_net", "encoder_decoder"):
            raise ValueError(model_name)
        self.n_classes = n_classes
        self.embedding_dim = embedding_dim
        self.model_name = model_name
        self.dtype = dtype
        if embedding_dim is not None:
            self.embedding = Embed(n_classes + 1, embedding_dim, generator)
        if model_name == "u_net":
            self.layer = UNet(3, n_classes, dtype, generator)
        else:
            self.layer = EncoderDecoder(embedding_dim or 1, n_classes, dtype,
                                        generator)

    def forward(self, mask: torch.Tensor, seg_gt: torch.Tensor,
                img: Optional[torch.Tensor] = None, train: bool = False
                ) -> torch.Tensor:
        if self.model_name == "u_net":
            onehot = seg_one_hot(seg_gt, self.n_classes)
            return self.layer(img, onehot, 1.0 - mask.float(), train=train)
        seg = torch.where(mask.bool(), self.n_classes, seg_gt.long())
        if self.embedding_dim is None:
            x2 = seg[..., None].float()
        else:
            x2 = self.embedding(seg)
            if self.dtype is not None:
                x2 = x2.to(self.dtype)
        x3 = self.layer(x2, train=train)
        seg_oh = seg_one_hot(seg_gt, self.n_classes)
        return x3 * mask[..., None].float() + seg_oh


def simple29_unet(embedding_dim: int = 15, **kw) -> Simple:
    return Simple(29, embedding_dim, "u_net", **kw)


def simple29_encoderdecoder(embedding_dim: int = 15, **kw) -> Simple:
    return Simple(29, embedding_dim, "encoder_decoder", **kw)
