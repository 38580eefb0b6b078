"""What makes a step over several ranks compute the step over the global
batch (the JAX package gets it from one program over a sharded batch).

- **Shares.** Each rank computes its share of the global loss, so that the
  shares add up to it; the gradients of the shares are summed over the
  ranks (``sum_over_ranks``, one flat all-reduce a step, the detached
  metric shares in the same bucket) and every rank applies the same
  update. A plain mean over the batch has the share local mean x local n /
  global n (``plain_share``; every rank holds the same number of rows).
  Losses whose normaliser, mask or sign depends on the whole batch
  (``losses/ce.py:class_weighted_ce``, the free-bits and capacity KL of
  ``losses/vae.py``) all-reduce those, detached, before the loss
  (``global_sum``).
- **Draws.** A per-sample random draw is made at the global batch's shape
  from the (seed, step) generator that every rank holds, and each rank
  takes its own rows (``draw_rows``): the draws of a 2-rank run are those
  of one process on the concatenated batch.

Outside a process group each helper is the identity and no collective
runs. Inside one it runs at world size 1 too, where NCCL's sum over one
rank is the identity.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import in_group, local_rows, process_count, process_index


def plain_share(x):
    """The rank's share of a plain batch mean ``x`` over its rows."""
    w = process_count()
    return x if w == 1 else x / w


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, detached (``t`` itself outside a
    group)."""
    if not in_group():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def draw_rows(draw: Callable[[int], torch.Tensor], n: int,
              dim: int = 0) -> torch.Tensor:
    """``draw(n_global)`` (a draw whose axis ``dim`` is the batch), cut to
    this rank's ``n`` rows of the global batch along ``dim``."""
    w = process_count()
    if w == 1:
        return draw(n)
    full = draw(n * w)
    return local_rows(full.movedim(dim, 0), process_index(), w).movedim(0,
                                                                        dim)


def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks: one flat bucket (one all-reduce) per
    dtype, returned as new tensors of the inputs' shapes. The inputs
    unchanged outside a group."""
    if not in_group():
        return list(tensors)
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def sum_over_ranks(grads: Mapping[str, torch.Tensor],
                   metrics: Mapping[str, torch.Tensor]):
    """The gradients of the ranks' loss shares, and their metric shares,
    summed over the ranks in one flat all-reduce (per dtype): the global
    batch's gradients and metrics. Both as they are outside a group."""
    if not in_group():
        return dict(grads), dict(metrics)
    g_names, m_names = list(grads), list(metrics)
    summed = all_reduce_flat([grads[k] for k in g_names]
                             + [metrics[k].float() for k in m_names])
    return (dict(zip(g_names, summed[:len(g_names)])),
            dict(zip(m_names, summed[len(g_names):])))
