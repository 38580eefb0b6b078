"""Learning-rate schedule policies (the JAX package's
``train/schedules.py``): linear | step | plateau | cosine, driven per epoch
by the host loop, which hands the rate to ``train/state.py:set_lr``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def linear_lr(base_lr: float, epoch: int, epoch_count: int = 1,
              niter: int = 100, niter_decay: int = 100) -> float:
    """Constant for ``niter`` epochs, then linear decay to 0 over
    ``niter_decay``."""
    scale = 1.0 - max(0, epoch + epoch_count - niter) / float(
        niter_decay + 1)
    return base_lr * scale


def step_lr(base_lr: float, epoch: int, decay_iters: int = 50,
            gamma: float = 0.1) -> float:
    return base_lr * (gamma ** (epoch // max(decay_iters, 1)))


def cosine_lr(base_lr: float, epoch: int, niter: int = 100,
              eta_min: float = 0.0) -> float:
    t = min(epoch, niter)
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * t / max(niter, 1))) / 2


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01, patience=5)
    parity, stateful on host."""
    base_lr: float
    factor: float = 0.2
    threshold: float = 0.01
    patience: int = 5
    lr: float = field(init=False)
    best: float = field(default=math.inf, init=False)
    bad_epochs: int = field(default=0, init=False)

    def __post_init__(self):
        self.lr = self.base_lr

    def update(self, metric: float) -> float:
        # rel-threshold 'min' mode: improvement if < best * (1 - threshold)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


def get_schedule(policy: str):
    """Name -> epoch-indexed schedule fn (plateau returns the class)."""
    return {"linear": linear_lr, "step": step_lr, "cosine": cosine_lr,
            "plateau": PlateauScheduler}[policy]
