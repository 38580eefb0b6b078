"""The control's precision: float8 (e4m3) in place of the bfloat16 that the
configurations state, the step below it that a later change would be
tempted to take for the convolutions.

``fp8`` rounds a tensor to float8 e4m3 with one scale per tensor (its
largest magnitude maps to 448, the format's largest finite value) and
returns it in float32. The rounding is taken as is in the forward pass and
passed over in the backward (the straight-through rule), so gradients stay
float32 as they would with float8 forward kernels.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    if x.requires_grad:
        return x + (_round_fp8(x) - x).detach()
    return _round_fp8(x)
