"""Trainer of the layout-only families, VAE / CVAE / ConvLSTM (the JAX
package's ``train/layout_trainer.py``).

It reads the triplet datasets of the main ``Trainer`` but uses only their
layouts, trains with the family's objective (KL-annealed where
variational; K-step exposure with ``multistep_k > 1`` on K+2-frame
windows), validates next-layout prediction with per-class IoU and pixel
accuracy (the confusion total summed on the device, one fetch), and
checkpoints under the arch ``layout_<family>``. It runs on the card unless
``cfg.device`` names the CPU; the nets' convs are the library's, as the
JAX package's are XLA's, so no hand-written kernel is launched and f32
runs on the card too.

Differences from the JAX ``LayoutTrainer``, each forced by the port:

- the noise of train step ``s`` (latent draws, prior feedback, layout
  corruption) comes from a generator on the device reseeded from ``(seed,
  s)`` (``trainer.py:step_seed``), and that of validation batch ``i`` from
  ``(seed + 1, i)``: a resumed run draws what an uninterrupted one draws.
  JAX's threefry streams are not reproduced;
- the initial weights come from a ``torch.Generator`` seeded with
  ``cfg.seed``: the same distributions as flax's, other numbers;
- the JAX ``ShardedLoader`` is the port's ``DeviceLoader``; over several
  ranks (one process a card, ``torchrun``) it runs as ``Trainer`` does:
  each rank loads its rows of the global batch, starts from rank 0's
  parameters, sums its gradients over the ranks in every step, draws the
  global batch's noise and takes its rows, all-reduces the validation's
  confusion total before its fetch, and rank 0 alone writes the log file
  and saves.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import torch

from ..config import Config
from ..device import resolve_device
from ..evaluation.metrics import confusion_matrix, summarize_confusion
from ..io.checkpoint import (CheckpointManager, copy_into, merge_params,
                             restore_opt_state)
from ..io.logging import get_logger
from ..models.convlstm import ConvLSTMLayoutPredictor
from ..models.vae import LayoutCVAE, LayoutVAE, one_hot_context
from ..ops.one_hot import seg_one_hot
from ..parallel.collectives import all_reduce_flat
from ..parallel.mesh import (build_then_barrier, in_group, is_primary,
                             replicate, training_mesh)
from .multistep import decode_window_batch, is_window_batch
from .state import TrainState, make_optimizer
from .steps import decode_batch
from .trainer import sharded_loader, step_seed
from .vae_steps import (capacity_schedule, kl_anneal,
                        make_convlstm_multistep_train_step,
                        make_convlstm_train_step,
                        make_cvae_multistep_train_step, make_cvae_train_step,
                        make_vae_train_step)

FAMILIES = ("vae", "cvae", "convlstm")


class LayoutTrainer:
    """family: 'vae' | 'cvae' | 'convlstm'."""

    def __init__(self, cfg: Config, family: str = "cvae",
                 latent_dim: int = 32, hidden: int = 64,
                 kl_warmup_steps: int = 500, beta_max: float = 1.0,
                 dataset_train=None, dataset_val=None,
                 free_bits: float = 0.0, kl_cycle_steps: int = 0,
                 capacity_max: float = 0.0, capacity_steps: int = 1000,
                 bg_weight: float = 1.0, vae_widths=None,
                 dec_refines: int = 1):
        """The posterior-collapse remedies (vae family only, all off by
        default; ``losses/vae.py``): ``free_bits``, ``kl_cycle_steps``
        (cyclical beta), ``capacity_max`` / ``capacity_steps`` (the Burgess
        capacity objective) and ``bg_weight`` (class 0's weight in the
        reconstruction CE)."""
        if family not in FAMILIES:
            raise ValueError(f"unknown layout family {family!r}")
        self.cfg = cfg
        self.mesh = training_mesh(cfg.mesh_shape)
        self.family = family
        self.kl_warmup = kl_warmup_steps
        self.beta_max = beta_max
        self.kl_cycle_steps = kl_cycle_steps
        self.capacity_max = capacity_max
        self.capacity_steps = capacity_steps
        self.device = dev = resolve_device(cfg.device)
        if cfg.path:
            os.makedirs(cfg.path, exist_ok=True)
        self.logger = get_logger(
            os.path.join(cfg.path, "experiment.log")
            if cfg.path and is_primary() else None)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        n_cls = cfg.n_classes
        init = torch.Generator().manual_seed(cfg.seed)
        self._noise_gen = torch.Generator(device=dev)

        # K-step exposure training: steps > 0 see the model's own fed-back
        # argmax as context; K=1 keeps the single-step steps
        self.multistep_k = int(cfg.multistep_k)
        if self.multistep_k > 1 and family == "vae":
            raise ValueError("multistep_k > 1 needs an autoregressive "
                             "family (cvae/convlstm); the vae family "
                             "autoencodes single frames")
        k, gen = self.multistep_k, self._noise_gen
        if family == "vae":
            self.model = LayoutVAE(
                n_cls, latent_dim,
                widths=tuple(vae_widths) if vae_widths else (32, 64, 128),
                dec_refines=dec_refines, dtype=dtype, generator=init)
            cw = ([bg_weight] + [1.0] * (n_cls - 1)
                  if bg_weight != 1.0 else None)
            self._step = make_vae_train_step(
                self.model, n_cls, free_bits=free_bits,
                use_capacity=capacity_max > 0.0, class_weights=cw,
                device=dev, generator=gen)
        elif family == "cvae":
            self.model = LayoutCVAE(n_cls, latent_dim, dtype=dtype,
                                    generator=init)
            if k > 1:
                self._step = make_cvae_multistep_train_step(
                    self.model, n_cls, k=k,
                    layout_noise=cfg.multistep_layout_noise, device=dev,
                    generator=gen)
            else:
                self._step = make_cvae_train_step(self.model, n_cls,
                                                  device=dev, generator=gen)
        else:
            self.model = ConvLSTMLayoutPredictor(n_cls, hidden, dtype=dtype,
                                                 generator=init)
            if k > 1:
                self._step = make_convlstm_multistep_train_step(
                    self.model, n_cls, k=k,
                    layout_noise=cfg.multistep_layout_noise, device=dev,
                    generator=gen)
            else:
                self._step = make_convlstm_train_step(self.model, n_cls,
                                                      device=dev)
        self.model.to(dev)
        tx = make_optimizer(cfg.optimizer, cfg.lr, max(cfg.beta1, 0.9))
        self.state = TrainState.create(self.model, tx)
        self.global_step = 0
        self.epoch = 0
        self.epoch_stats: Dict[str, float] = {}
        ckpt_dir = os.path.join(cfg.path, "checkpoint") if cfg.path else None
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.warm_start_report: Dict[str, list] = {}
        if cfg.ckpt:
            # weights-only warm start (fresh optimizer and epoch): the
            # objective-switch recipe onto the K-step objective
            self._warm_start(cfg.ckpt)
        if cfg.resume:
            self.load_checkpoint(cfg.resume)
        if in_group():
            build_then_barrier(dev)
            replicate(list(self.model.parameters())
                      + list(self.model.buffers()))

        if dataset_train is None:
            from ..data import get_dataset
            dataset_train, dataset_val = get_dataset(cfg)
        self.train_loader = sharded_loader(cfg, dataset_train, True, dev)
        self.val_loader = sharded_loader(cfg, dataset_val, False, dev)

    # ------------------------------------------------------------------
    def _warm_start(self, path: str):
        tree = CheckpointManager.restore_path(path)
        live = self.model.state_dict(keep_vars=True)
        merged, rep = merge_params(live, tree["params"])
        if not rep["loaded"]:
            raise ValueError(f"ckpt {path} shares no parameters with the "
                             f"live layout_{self.family} model")
        copy_into(live, merged)
        self.warm_start_report = rep
        self.logger.info(
            "[layout/%s] warm start from %s: %d loaded, %d missing, "
            "%d unexpected", self.family, path, len(rep["loaded"]),
            len(rep["missing"]), len(rep["unexpected"]))

    def _seed_noise(self, seed: int, index: int):
        self._noise_gen.manual_seed(step_seed(seed, index))

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        """Argmax layout ids of a decoded triplet batch: the VAE autoencodes
        seg3, the CVAE samples its prior from (seg1, seg2), the ConvLSTM
        predicts from (seg1, seg2). Noise from the trainer's generator."""
        n_cls = self.cfg.n_classes
        if self.family == "vae":
            logits = self.model(seg_one_hot(batch["seg3"], n_cls),
                                generator=self._noise_gen)[0]
        elif self.family == "cvae":
            ctx = one_hot_context(batch["seg1"][..., 0], batch["seg2"][..., 0],
                                  n_cls)
            logits = self.model.generate(ctx, generator=self._noise_gen)
        else:
            ctx = torch.stack([batch["seg1"][..., 0], batch["seg2"][..., 0]],
                              1)
            logits = self.model(seg_one_hot(ctx, n_cls))
        return logits.argmax(-1)

    def _train_on(self, batch) -> Dict[str, torch.Tensor]:
        """One train step on a loader batch (triplet or window)."""
        self.global_step += 1
        self._seed_noise(self.cfg.seed, self.global_step)
        beta = kl_anneal(self.global_step, self.kl_warmup, self.beta_max,
                         self.kl_cycle_steps)
        if is_window_batch(batch):
            # the K-step exposure objective over the window's layouts
            _, segs = decode_window_batch(batch)
            if self.family == "cvae":
                self.state, metrics = self._step(self.state, segs, beta)
            else:
                self.state, metrics = self._step(self.state, segs)
            return metrics
        if self.multistep_k > 1:
            raise ValueError(
                "multistep_k > 1 needs the window batch contract (K+2-frame "
                "train dataset; data.get_dataset emits it)")
        batch = decode_batch(batch)
        if self.family == "vae":
            args = (self.state, batch["seg3"], beta)
            if self.capacity_max > 0.0:
                args += (capacity_schedule(self.global_step,
                                           self.capacity_max,
                                           self.capacity_steps),)
            self.state, metrics = self._step(*args)
            return metrics
        ctx = torch.stack([batch["seg1"][..., 0], batch["seg2"][..., 0]], 1)
        if self.family == "cvae":
            self.state, metrics = self._step(self.state, ctx, batch["seg3"],
                                             beta)
        else:
            self.state, metrics = self._step(self.state, ctx, batch["seg3"])
        return metrics

    def train_epoch(self) -> Dict[str, float]:
        self.train_loader.set_epoch(self.epoch)
        metrics: Dict[str, torch.Tensor] = {}
        t0 = time.perf_counter()
        steps = 0
        for batch in self.train_loader:
            metrics = self._train_on(batch)
            steps += 1
        # the epoch's one fetch: every queued step has run after it
        out = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        self.epoch += 1
        self.epoch_stats = dict(steps=steps, wall_s=wall,
                                samples=steps * self.cfg.batch_size)
        self.logger.info("[layout/%s] epoch %d %s (%d steps in %.3fs)" % (
            self.family, self.epoch,
            " ".join(f"{k}={v:.4f}" for k, v in out.items()), steps, wall))
        return out

    def validate(self) -> Dict[str, object]:
        cm_total = None
        for i, batch in enumerate(self.val_loader):
            batch = decode_batch(batch)
            self._seed_noise(self.cfg.seed + 1, i)
            cm = confusion_matrix(self.predict(batch), batch["seg3"],
                                  self.cfg.n_classes)
            cm_total = cm if cm_total is None else cm_total + cm
        if cm_total is not None and in_group():
            cm_total, = all_reduce_flat([cm_total])
        iou, miou, acc = summarize_confusion(cm_total, self.cfg.n_classes)
        self.logger.info("[layout/%s] val mIoU %.4f pixAcc %.4f" % (
            self.family, miou, acc))
        return {"miou": miou, "pixel_acc": acc, "per_class_iou": iou}

    def save_checkpoint(self):
        if self.ckpt is not None and is_primary():
            self.ckpt.save(self.epoch, self.model.state_dict(),
                           self.state.opt_state, self.global_step,
                           f"layout_{self.family}")

    def load_checkpoint(self, resume: str):
        """Full resume (epoch, step, parameters and optimizer state, in
        place); takes "latest" or a path."""
        if resume == "latest" and self.ckpt is not None:
            resume = os.path.join(self.ckpt.directory, "latest")
        tree = CheckpointManager.restore_path(
            resume, arch=f"layout_{self.family}")
        self.epoch = int(tree["epoch"])
        self.global_step = int(tree.get("step", 0))
        restore_opt_state(self.state.opt_state, tree["opt_state"])
        copy_into(self.model.state_dict(keep_vars=True), tree["params"])
        self.state.step = self.global_step
        self.logger.info("[layout/%s] resumed at epoch %d"
                         % (self.family, self.epoch))

    def fit(self) -> Dict[str, object]:
        metrics: Dict[str, object] = {}
        # self.epoch counts completed epochs (restored on resume)
        for _ in range(self.epoch, self.cfg.epochs):
            self.train_epoch()
            metrics = self.validate()
            self.save_checkpoint()
        return metrics
