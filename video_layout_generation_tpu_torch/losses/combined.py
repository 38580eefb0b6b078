"""Combined perceptual loss = VGG + SSIM + gradient (the JAX package's
``losses/combined.py``). ``CombinedLoss`` carries the frozen VGG trunk and
is a plain callable."""

from __future__ import annotations

import dataclasses
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
    # The fused SSIM kernel (ops/kernels/ssim.py). Its backward re-runs the
    # plain formula, so only paths that are never differentiated (the
    # validation step) switch it on.
    ssim_use_kernel: bool = False

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

    def eval_variant(self) -> "CombinedLoss":
        """Copy for non-differentiated (validation) use: fused SSIM."""
        return dataclasses.replace(self, ssim_use_kernel=True)

    def __call__(self, output: torch.Tensor, target: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version (the
        on-card reference), the SSIM term included."""
        return (vgg_feature_loss(self.vgg_model, output, target, plain)
                + gradient_loss(output, target)
                + ssim_loss(output, target,
                            use_kernel=self.ssim_use_kernel and not plain))
