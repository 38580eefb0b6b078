"""Combined perceptual loss = VGG + SSIM + gradient (the JAX package's
``losses/combined.py``). ``CombinedLoss`` carries the frozen VGG trunk and
is a plain callable."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from ..device import resolve_device
from .pixel import gradient_loss
from .ssim import ssim_loss
from .vgg import VGG19Features, make_vgg_loss, vgg_feature_loss


@dataclass(frozen=True)
class CombinedLoss:
    vgg_model: VGG19Features

    @classmethod
    def create(cls, vgg_weights: Optional[str] = None,
               dtype: Optional[torch.dtype] = None,
               params: Optional[Mapping] = None, seed: int = 0,
               device="cuda") -> "CombinedLoss":
        """The loss with its VGG trunk (``make_vgg_loss``'s arguments) on
        ``device``; raises for a CUDA device when the process has none.
        ``dtype=None`` is bf16 on a CUDA device, the only activation dtype
        the conv kernels take, and the input's dtype on the CPU."""
        dev = resolve_device(device)
        if dtype is None and dev.type == "cuda":
            dtype = torch.bfloat16
        return cls(make_vgg_loss(vgg_weights, dtype, params, seed).to(dev))

    def __call__(self, output: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        return (vgg_feature_loss(self.vgg_model, output, target)
                + gradient_loss(output, target) + ssim_loss(output, target))
