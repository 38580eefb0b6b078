"""Cross-entropy losses over segmentation logits, NHWC, in f32 (the JAX
package's ``losses/ce.py``).

- ``cross_entropy_loss``: mean CE over all pixels.
- ``class_weighted_ce``: sum(w_y * ce) / sum(w_y), torch
  ``nn.CrossEntropyLoss(weight=w)``. Under a process group sum(w_y) is the
  global batch's (all-reduced, detached: it depends on the labels only), so
  each rank returns its share and the shares add up to the global loss.
- ``weighted_masked_ce``: class-weighted CE summed over all pixels and
  divided by the count of unmasked pixels (the legacy completion loss).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.collectives import global_sum


def _picked_logp(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log-softmax of the labelled class at every pixel, (N, H, W) f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def _weights_of(class_weights, labels: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=labels.device)
    return w[labels.long()]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """logits (N, H, W, C) any float dtype; labels (N, H, W) int."""
    return -_picked_logp(logits, labels).mean()


def class_weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                      class_weights) -> torch.Tensor:
    w = _weights_of(class_weights, labels)
    total = (-_picked_logp(logits, labels) * w).sum()
    return total / global_sum(w.sum()).clamp_min(1e-6)


def weighted_masked_ce(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor,
                       class_weights: Sequence[float]) -> torch.Tensor:
    """``mask == 1`` marks the cropped region; the sum over all pixels is
    divided by the count of pixels outside it."""
    w = _weights_of(class_weights, labels)
    total = (-_picked_logp(logits, labels) * w).sum()
    return total / (1.0 - mask.float()).sum().clamp_min(1.0)
