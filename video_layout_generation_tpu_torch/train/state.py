"""Train state and optimizers (the JAX package's ``train/state.py``).

adam / adamax with (beta1, 0.999) and sgd, computed as optax computes them
(bias correction of both moments, ``eps`` added to the root of the corrected
second moment; adamax's infinity norm ``max(b2 * nu, |g| + eps)``), so that
one step moves the parameters as the JAX package's step does. The learning
rate lives in the optimizer state and the host loop sets it per epoch.

Unlike the JAX state, which is immutable, ``apply_gradients`` updates the
parameters and the moments in place (f32) and returns the same object: a
functional copy would double the memory traffic of the update.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Union

import torch
from torch import nn

B2 = 0.999
EPS = 1e-8

# Since the process started: the updates made, the parameter tensors they
# covered and the (device, dtype) groups they ran as; the Trainer reports an
# epoch's in its epoch line and ``epoch_stats``.
GROUPED = {"updates": 0, "tensors": 0, "groups": 0}


@dataclass(frozen=True)
class Optimizer:
    """What ``make_optimizer`` returns: the rule and its constants."""
    name: str
    lr: float
    beta1: float
    moment_dtype: Optional[torch.dtype] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        state = {"learning_rate": float(self.lr), "count": 0}
        if self.name in ("adam", "adamax"):
            mu_dt = self.moment_dtype
            state["mu"] = {k: torch.zeros_like(p, dtype=mu_dt or p.dtype)
                           for k, p in params.items()}
            state["nu"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: dict) -> None:
        """One step on ``params`` and ``state``, in place, as a few grouped
        (``torch._foreach_*``) calls over each (device, dtype) group of
        tensors: each call is the per-tensor op it replaces, element for
        element, so the bits are those of a loop over the tensors. (Not for
        bf16 parameters on the CPU, whose grouped in-place multiply rounds
        the number to bf16 first; parameters are f32 on every path.)"""
        state["count"] += 1
        groups: Dict[tuple, List[str]] = {}
        for k, p in params.items():
            groups.setdefault((p.device, p.dtype), []).append(k)
        for keys in groups.values():
            self._update_group(keys, params, grads, state)
        GROUPED["updates"] += 1
        GROUPED["tensors"] += len(params)
        GROUPED["groups"] += len(groups)

    def _update_group(self, keys: List[str],
                      params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, torch.Tensor], state: dict) -> None:
        lr = state["learning_rate"]
        t = state["count"]
        b1 = self.beta1
        ps = [params[k] for k in keys]
        gs = [grads[k].to(p.dtype) for k, p in zip(keys, ps)]
        if self.name == "sgd":
            torch._foreach_add_(ps, gs, alpha=-lr)
            return
        mus_kept = [state["mu"][k] for k in keys]
        nus = [state["nu"][k] for k in keys]
        mus = mus_kept
        if mus_kept[0].dtype != ps[0].dtype:
            # f32 copies only where the first moment is kept in reduced
            # precision
            mus = [torch.empty_like(p) for p in ps]
            torch._foreach_copy_(mus, mus_kept)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, gs, alpha=1 - b1)
        mu_hats = torch._foreach_div(mus, 1 - b1 ** t)
        torch._foreach_mul_(nus, B2)
        if self.name == "adam":
            torch._foreach_addcmul_(nus, gs, gs, value=1 - B2)
            denoms = torch._foreach_div(nus, 1 - B2 ** t)
            torch._foreach_sqrt_(denoms)
            torch._foreach_add_(denoms, EPS)
        else:
            floors = torch._foreach_abs(gs)
            torch._foreach_add_(floors, EPS)
            torch._foreach_maximum_(nus, floors)
            denoms = nus
        torch._foreach_addcdiv_(ps, mu_hats, denoms, value=-lr)
        if mus is not mus_kept:
            torch._foreach_copy_(mus_kept, mus)


def make_optimizer(optimizer: str = "adam", lr: float = 2e-4,
                   beta1: float = 0.5,
                   moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """``moment_dtype`` (e.g. ``torch.bfloat16``) keeps adam's first moment
    in reduced precision; the update itself is computed in f32 and the
    second moment stays f32. Only adam takes it."""
    if optimizer not in ("adam", "adamax", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if moment_dtype is not None and optimizer != "adam":
        raise ValueError(f"moment_dtype is supported by adam only, not by "
                         f"{optimizer}")
    return Optimizer(optimizer, lr, beta1, moment_dtype)


@dataclass
class TrainState:
    """``params`` maps names to the trained tensors (a module's own
    parameters, not copies); ``step`` counts updates."""
    params: Dict[str, torch.Tensor]
    opt_state: dict
    tx: Optimizer
    step: int = 0
    module: Optional[nn.Module] = field(default=None, repr=False)

    @classmethod
    def create(cls, model: Union[nn.Module, Mapping[str, torch.Tensor]],
               tx: Optimizer) -> "TrainState":
        """State over the parameters of ``model`` that require grad (or over
        a name -> tensor mapping). The moments are made on the parameters'
        device: move the module there first."""
        if isinstance(model, nn.Module):
            params = {k: p for k, p in model.named_parameters()
                      if p.requires_grad}
            return cls(params, tx.init(params), tx, 0, model)
        params = dict(model)
        return cls(params, tx.init(params), tx, 0, None)

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        self.tx.update(self.params, grads, self.opt_state)
        self.step += 1
        return self


def current_lr(state: TrainState) -> float:
    return float(state.opt_state["learning_rate"])


def set_lr(state: TrainState, lr: float) -> TrainState:
    state.opt_state["learning_rate"] = float(lr)
    return state


def epoch_decayed_lr(base_lr: float, epoch: int, decay_step: int,
                     decay_gamma: float) -> float:
    """Staircase decay: lr * gamma^(epoch // step)."""
    return base_lr * (decay_gamma ** (epoch // max(decay_step, 1)))
