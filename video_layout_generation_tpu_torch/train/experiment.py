"""Multi-network experiment base (the JAX package's ``train/experiment.py``).

The pix2pix ``BaseModel`` harness: named (module, ``TrainState``) pairs
with per-net learning-rate policies (``train/schedules.py``, plateau
included), eval / test wrappers, ordered loss and visual dicts for display,
per-net save and load under ``<epoch>_net_<name>`` (one ``torch.save`` file
each, in place of the JAX package's orbax directory) and freezing: the
gradients of a frozen net are zeroed (``mask_frozen``), as the JAX
package's optax mask does, and its parameters still belong to its state.
"""

from __future__ import annotations

import abc
import os
from collections import OrderedDict
from typing import Any, Dict, Mapping

import torch

from ..io.checkpoint import copy_into
from .schedules import PlateauScheduler, get_schedule
from .state import TrainState, current_lr, set_lr


class ExperimentBase(abc.ABC):
    """Manage named (module, TrainState) pairs with schedulers and I/O."""

    def __init__(self, save_dir: str, lr_policy: str = "linear",
                 is_train: bool = True, **policy_kw):
        self.save_dir = save_dir
        self.is_train = is_train
        self.lr_policy = lr_policy
        self.policy_kw = policy_kw
        self.nets: "OrderedDict[str, Any]" = OrderedDict()
        self.states: "OrderedDict[str, TrainState]" = OrderedDict()
        self.frozen: set = set()
        self.loss_names: list = []
        self.visual_names: list = []
        self.metric = 0.0            # the plateau policy's input
        self._base_lrs: Dict[str, float] = {}
        self._plateaus: Dict[str, PlateauScheduler] = {}
        os.makedirs(save_dir, exist_ok=True)

    # -- network registry ----------------------------------------------
    def register(self, name: str, module, state: TrainState):
        self.nets[name] = module
        self.states[name] = state
        # schedules scale from the registration-time rate, not a later
        # (already decayed) one
        self._base_lrs[name] = current_lr(state)
        if self.lr_policy == "plateau":
            self._plateaus[name] = PlateauScheduler(current_lr(state))

    # -- abstract experiment hooks --------------------------------------
    @abc.abstractmethod
    def set_input(self, batch):
        ...

    @abc.abstractmethod
    def forward(self):
        ...

    @abc.abstractmethod
    def optimize_parameters(self):
        ...

    # -- schedulers ------------------------------------------------------
    def update_learning_rate(self, epoch: int) -> Dict[str, float]:
        """Per-epoch learning rate of every registered net."""
        for name, st in self.states.items():
            if self.lr_policy == "plateau":
                lr = self._plateaus[name].update(self.metric)
            else:
                lr = get_schedule(self.lr_policy)(self._base_lrs[name],
                                                  epoch, **self.policy_kw)
            set_lr(st, lr)
        return {n: current_lr(s) for n, s in self.states.items()}

    # -- freezing (set_requires_grad) -------------------------------------
    def set_requires_grad(self, names, requires_grad: bool):
        names = [names] if isinstance(names, str) else names
        for n in names:
            (self.frozen.discard if requires_grad else self.frozen.add)(n)

    def mask_frozen(self, name: str, grads: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The gradients of net ``name``, zeroed when it is frozen."""
        if name in self.frozen:
            return {k: torch.zeros_like(g) for k, g in grads.items()}
        return dict(grads)

    # -- eval / test -----------------------------------------------------
    def eval(self):
        self.is_train = False

    def test(self, batch):
        self.set_input(batch)
        with torch.no_grad():
            out = self.forward()
        self.compute_visuals()
        return out

    def compute_visuals(self):
        pass

    def get_current_visuals(self) -> "OrderedDict[str, Any]":
        return OrderedDict((n, getattr(self, n))
                           for n in self.visual_names if hasattr(self, n))

    def get_current_losses(self) -> "OrderedDict[str, float]":
        return OrderedDict((n, float(getattr(self, "loss_" + n)))
                           for n in self.loss_names
                           if hasattr(self, "loss_" + n))

    # -- per-net save / load (<epoch>_net_<name>) ------------------------
    def _net_path(self, epoch, name) -> str:
        return os.path.join(self.save_dir, f"{epoch}_net_{name}")

    def save_networks(self, epoch):
        for name, st in self.states.items():
            params = {k: v.detach().to("cpu", copy=True)
                      for k, v in st.params.items()}
            torch.save({"params": params}, self._net_path(epoch, name))

    def load_networks(self, epoch):
        """Restore each net's parameters in place."""
        for name in self.nets:
            tree = torch.load(self._net_path(epoch, name),
                              map_location="cpu", weights_only=True)
            copy_into(self.states[name].params, tree["params"])

    def print_networks(self, verbose: bool = False):
        print("---------- Networks initialized -------------")
        for name, st in self.states.items():
            n_params = sum(p.numel() for p in st.params.values())
            if verbose:
                print(self.nets[name])
            print("[Network %s] Total number of parameters : %.3f M"
                  % (name, n_params / 1e6))
        print("-----------------------------------------------")
