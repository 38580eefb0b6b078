"""Variational objectives of the layout VAE / CVAE family, in f32 (the JAX
package's ``losses/vae.py``).

- ``kl_standard_normal``: KL(q(z|x) || N(0, 1)), summed over the latent and
  meaned over the batch.
- ``kl_standard_normal_free_bits``: the same with a per-dimension floor;
  returns ``(kl_used, kl_raw)``.
- ``kl_gaussians``: KL(q || p) of two diagonal Gaussians (the CVAE's
  posterior against its learned prior).
- ``vae_loss`` / ``cvae_loss``: CE reconstruction + beta * KL; beta comes
  from the caller (``train/vae_steps.py:kl_anneal``).

The posterior-collapse remedies of ``vae_loss`` are opt-in, and the
defaults are the plain ELBO: ``free_bits`` (a per-dimension KL floor whose
clamped dimensions carry no gradient), ``capacity`` (the objective
``recon + beta * |KL - C|``, which takes precedence for the KL term) and
``class_weights`` (class-weighted reconstruction CE).

Under a process group ``vae_loss`` returns each rank's share of the global
batch's objective and metrics (the shares add up to them): the class
weights' sum, the free-bits mask (from the global per-dimension mean) and
the capacity term's sign (from the global KL) are all-reduced, detached,
before the loss. Outside a group the values are the batch's own.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import global_sum, plain_share
from ..parallel.mesh import process_count
from .ce import class_weighted_ce, cross_entropy_loss


def _kl_terms(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-element KL(N(mu, exp(logvar)) || N(0, 1)), f32, (N, D)."""
    mu, logvar = mu.float(), logvar.float()
    kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar))
    return kl.reshape(kl.shape[0], -1)


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor
                       ) -> torch.Tensor:
    return _kl_terms(mu, logvar).sum(1).mean()


def kl_standard_normal_free_bits(mu: torch.Tensor, logvar: torch.Tensor,
                                 free_bits: float):
    """Sum over latent dimensions of max(batch-mean KL, free_bits).

    Returns (kl_used, kl_raw): kl_used feeds the loss, kl_raw (the true KL)
    is reported so that collapse stays visible in the metrics. Under a
    process group both are the rank's shares: the batch mean is the global
    batch's, and a dimension is floored where its global mean is."""
    per_dim = plain_share(_kl_terms(mu, logvar).mean(0))
    floor = free_bits / process_count()
    used = torch.where(global_sum(per_dim) > free_bits, per_dim,
                       torch.full_like(per_dim, floor))
    return used.sum(), per_dim.sum()


def kl_gaussians(mu_q, lv_q, mu_p, lv_p) -> torch.Tensor:
    mu_q, lv_q, mu_p, lv_p = (t.float() for t in (mu_q, lv_q, mu_p, lv_p))
    kl = 0.5 * (lv_p - lv_q
                + (torch.exp(lv_q) + (mu_q - mu_p) ** 2) / torch.exp(lv_p)
                - 1.0)
    return kl.reshape(kl.shape[0], -1).sum(1).mean()


def vae_loss(logits, target_ids, mu, logvar, beta: float = 1.0,
             free_bits: float = 0.0, capacity=None,
             class_weights: Optional[torch.Tensor] = None):
    """(total, metrics) of the VAE objective; ``capacity`` (a scalar or
    None) takes precedence over ``free_bits`` for the KL term, and both
    report the raw KL. Under a process group, the rank's shares."""
    if class_weights is not None:
        recon = class_weighted_ce(logits, target_ids, class_weights)
    else:
        recon = plain_share(cross_entropy_loss(logits, target_ids))
    if free_bits > 0.0:
        kl_used, kl = kl_standard_normal_free_bits(mu, logvar, free_bits)
    else:
        kl = plain_share(kl_standard_normal(mu, logvar))
        kl_used = kl
    if capacity is None:
        kl_term = kl_used
    else:
        # |KL - C| as sign(global KL - C) * (the rank's KL share - C/world)
        sign = torch.sign(global_sum(kl_used) - capacity).detach()
        kl_term = sign * (kl_used - capacity / process_count())
    total = recon + beta * kl_term
    return total, {"loss": total, "recon": recon, "kl": kl}


def cvae_loss(logits, target_ids, q_stats, p_stats, beta: float = 1.0):
    recon = cross_entropy_loss(logits, target_ids)
    kl = kl_gaussians(*q_stats, *p_stats)
    total = recon + beta * kl
    return total, {"loss": total, "recon": recon, "kl": kl}
