"""Input assembly and normalization constants (NHWC), as the JAX package's
``train/assemble.py``: ImageNet normalization of frames, the model-output
affine map, and the channel concatenation [edge1, seg1, frame1, frame2,
seg2, edge2] (10 channels with edges) or [seg1, frame1, frame2, seg2]
(8 channels, the rollout contract)."""

from __future__ import annotations

import functools
from typing import Optional

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUT_MEAN = (-0.03, -0.088, -0.188)
OUT_STD = (0.448, 0.448, 0.450)


@functools.lru_cache(maxsize=None)
def _const(vals: tuple, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from the host inside the rollout loop
    # would wait for the device on every frame. Made outside inference mode
    # even when the rollout asks first: the train step saves it for backward
    with torch.inference_mode(False):
        return torch.tensor(vals, dtype=torch.float32, device=device)


def const_like(vals, like: torch.Tensor) -> torch.Tensor:
    """``vals`` as an f32 tensor on ``like``'s device."""
    return _const(vals, like.device)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB -> ImageNet-normalized."""
    return ((img - const_like(IMAGENET_MEAN, img))
            / const_like(IMAGENET_STD, img))


def denormalize_image(img: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized -> [0,1]-range RGB."""
    return (img * const_like(IMAGENET_STD, img)
            + const_like(IMAGENET_MEAN, img))


def normalize_model_output(img: torch.Tensor) -> torch.Tensor:
    """Map the raw img head output into ImageNet-normalized space."""
    return (img - const_like(OUT_MEAN, img)) / const_like(OUT_STD, img)


def assemble_model_input(seg1: torch.Tensor, frame1: torch.Tensor,
                         frame2: torch.Tensor, seg2: torch.Tensor,
                         edge1: Optional[torch.Tensor] = None,
                         edge2: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Concatenate the model input channels. Frames are ImageNet-normalized,
    segs float class ids (N,H,W,1), edges the fused HNED map or None."""
    if edge1 is not None:
        parts = [edge1, seg1, frame1, frame2, seg2, edge2]
    else:
        parts = [seg1, frame1, frame2, seg2]
    return torch.cat(parts, dim=-1)
