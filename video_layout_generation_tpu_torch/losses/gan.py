"""GAN objectives and the WGAN-GP gradient penalty (the JAX package's
``losses/gan.py``):

- ``lsgan``:   MSE against 1 / 0 targets
- ``vanilla``: BCE-with-logits against 1 / 0 targets
- ``wgangp``:  -mean(pred) for real, +mean(pred) for fake

The penalty differentiates the critic with respect to its input and is
itself differentiated with respect to the critic's parameters
(``create_graph=True``); every kernel on the critic's path supports that.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.collectives import draw_rows


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             gan_mode: str = "lsgan", real_label: float = 1.0,
             fake_label: float = 0.0) -> torch.Tensor:
    pred = prediction.float()
    target = real_label if target_is_real else fake_label
    if gan_mode == "lsgan":
        return ((pred - target) ** 2).mean()
    if gan_mode == "vanilla":
        # softplus(-x) for target 1, softplus(x) for target 0
        return (pred.clamp_min(0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    if gan_mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     interp_type: str = "mixed", constant: float = 1.0,
                     lambda_gp: float = 10.0):
    """WGAN-GP penalty; ``critic_fn`` maps (N, H, W, C) to patch logits.
    ``generator`` draws the per-sample mixing weights of ``mixed`` (on
    ``real``'s device). Returns (penalty, gradients); the penalty carries
    the graph back to the critic's parameters."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device), None
    real, fake = real.float(), fake.float()
    if interp_type == "real":
        x = real
    elif interp_type == "fake":
        x = fake
    elif interp_type == "mixed":
        # this rank's rows of the global batch's draw
        alpha = draw_rows(lambda m: torch.rand(
            (m, 1, 1, 1), generator=generator, device=real.device),
            real.shape[0])
        x = alpha * real + (1.0 - alpha) * fake
    else:
        raise NotImplementedError(f"{interp_type} not implemented")
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        out = critic_fn(x).float().sum()
        grads, = torch.autograd.grad(out, x, create_graph=True)
        flat = grads.reshape(real.shape[0], -1)
        norms = torch.linalg.vector_norm(flat + 1e-16, dim=1)
        penalty = ((norms - constant) ** 2).mean() * lambda_gp
    return penalty, grads
