"""Training orchestration (the JAX package's ``train/trainer.py``).

``Trainer`` builds the generator, the frozen HNED, the loss stack, the
optimizer state, the optional discriminator, the loaders and the writer,
then runs the epoch loop: train -> validate -> checkpoint, with warm start
(``ckpt``), resume (``resume``), TensorBoard scalars and images, ``.npy``
dumps of validation batches and rollouts, and rollout fidelity. It drives
the step functions of ``train/steps.py``, ``train/gan.py``,
``train/multistep.py`` (``multistep_k > 1``) and ``train/scheduled.py``
(``scheduled_sampling``) one step at a time, on batches from the host or
rendered on the card (``data/device_synthetic.py``: ``device_data``), and
the rollout of ``train/rollout.py``, on the card unless ``cfg.device``
names the CPU; every 3x3 conv of the path is a launch of kernel A or B
there.

Differences from the JAX ``Trainer``, each forced by the port:

- the step's flip coin comes from a ``torch.Generator`` reseeded from
  ``(cfg.seed, global_step)`` before every step (``step_seed``): a resumed
  run draws the coins of an uninterrupted one and the checkpoint holds no
  generator state. The JAX loop's threefry ``fold_in`` stream cannot be
  reproduced, so the coins differ from the JAX package's; the generator
  stays on the host, where a batch coin costs the step no wait for the
  card. The WGAN-GP mixing weights, the K-step feedback noise and layout
  corruption and the scheduled-sampling mask come from a generator on the
  device, reseeded the same way;
- restores write into the live tensors with ``copy_`` (parameters,
  buffers, moments; ``learning_rate`` and ``count`` by value), since the
  train state holds the modules' own parameters and the kernels' weight
  packs are keyed on the tensor's version;
- ``check_options`` raises the JAX package's ``ValueError`` for the
  combinations it refuses, before anything is built;
- ``chunk_steps`` and ``epoch_scan`` (the JAX package's scan executors)
  change nothing: the loop runs every step itself (``config.py``);
- data parallelism is one process a card (``torchrun``; the JAX package
  runs one program over a mesh): ``mesh_shape`` must multiply out to the
  world size, each rank loads its ``batch_size // world`` rows of the
  global batch, the parameters are broadcast from rank 0 once after the
  kernels are built on every rank, each step sums its gradients over the
  ranks (``parallel/collectives.py``), validation all-reduces its loss and
  confusion sums on the device before its one fetch, and rank 0 alone
  logs to the file, writes TensorBoard events, dumps (every rank's rows,
  gathered) and saves. Resume and warm start read on every rank.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import DeviceLoader, HostLoader
from ..device import resolve_device
from ..evaluation.export import save_npy_stack
from ..evaluation.metrics import summarize_confusion
from ..io.checkpoint import (CheckpointManager, copy_into, merge_params,
                             restore_opt_state)
from ..io.logging import get_logger
from ..io.tb import SummaryWriter
from ..io.weights import load_hned_params
from ..losses.combined import CombinedLoss
from ..models import HNED, get_model_cls
from ..ops.colorize import colorize_seg
from ..parallel.collectives import all_reduce_flat
from ..parallel.mesh import (build_then_barrier, in_group, is_primary,
                             process_count, process_index, replicate,
                             training_mesh)
from ..utils.meters import StepTimer
from ..utils.profiling import annotate
from .assemble import denormalize_image, normalize_image
from .gan import GanTrainState, make_gan_train_step
from .multistep import (is_window_batch, make_multistep_train_step,
                        window_to_triplet_batch)
from .rollout import make_rollout_fn
from .scheduled import make_scheduled_train_step, scheduled_p
from .state import (GROUPED, TrainState, current_lr, epoch_decayed_lr,
                    make_optimizer, set_lr)
from .steps import decode_batch, make_eval_step, make_train_step


def validate(eval_step: Callable, batches: Iterable, n_classes: int,
             on_batch: Optional[Callable] = None) -> Dict[str, object]:
    """Run ``eval_step`` (from ``make_eval_step`` with ``n_classes``) over
    ``batches`` and return the size-weighted mean loss, mIoU, pixel
    accuracy and per-class IoU. ``on_batch(i, batch, seg_ids, img_n)`` is
    called after each batch when given.

    The loss sum and the confusion total stay on the device while the
    batches run; under a process group they are summed over the ranks
    there (each rank ran its rows of every global batch), and the only
    fetch is at the end. A loader that produced no batch gives a NaN loss,
    zero scores and NaN per-class IoU."""
    loss_sum = None
    n_total = 0
    cm_total = None
    for i, batch in enumerate(batches):
        metrics, seg_ids, img_n = eval_step(batch)
        bs = next(iter(batch.values())).shape[0]
        n_total += bs
        contrib = metrics["loss"] * bs
        loss_sum = contrib if loss_sum is None else loss_sum + contrib
        cm = metrics["cm"]
        cm_total = cm if cm_total is None else cm_total + cm
        if on_batch is not None:
            on_batch(i, batch, seg_ids, img_n)
    if cm_total is not None and in_group():
        loss_sum, cm_total = all_reduce_flat([loss_sum, cm_total])
        n_total *= process_count()     # every rank holds as many rows
    iou, miou, acc = summarize_confusion(cm_total, n_classes)
    if cm_total is None:
        return {"loss": float("nan"), "miou": miou, "pixel_acc": acc,
                "per_class_iou": iou}
    return {"loss": float(loss_sum) / n_total, "miou": miou,
            "pixel_acc": acc, "per_class_iou": iou}


def check_options(cfg: Config) -> None:
    """The JAX ``Trainer``'s ``ValueError`` for each combination of step and
    executor it refuses, with its message, in its order (the executors
    have no effect here, but a configuration valid in one package is
    valid in the other)."""
    executor = cfg.epoch_scan or cfg.chunk_steps > 1
    refused = [
        (cfg.gan_train and cfg.multistep_k > 1,
         "multistep_k > 1 is not supported with gan_train (single-step "
         "adversarial loss)"),
        (cfg.gan_train and cfg.scheduled_sampling > 0,
         "scheduled_sampling is not supported with gan_train (single-step "
         "adversarial loss)"),
        (cfg.multistep_k > 1 and cfg.scheduled_sampling > 0,
         "scheduled_sampling and multistep_k > 1 are separate "
         "rollout-fidelity objectives; pick one"),
        (executor and cfg.gan_train,
         "epoch_scan / chunk_steps need a non-GAN trainer (scan carries one "
         "TrainState)"),
        (executor and cfg.scheduled_sampling > 0,
         "scheduled_sampling is per-step only (its p-ramp changes the "
         "program across epochs)"),
        (cfg.epoch_scan and not cfg.device_data,
         "epoch_scan requires device_data=True (use chunk_steps for "
         "host-fed data)"),
        (cfg.chunk_steps > 1 and cfg.device_data,
         "chunk_steps is the host-fed executor; device_data already has "
         "epoch_scan"),
    ]
    for bad, msg in refused:
        if bad:
            raise ValueError(msg)


def sharded_loader(cfg: Config, dataset, shuffle: bool,
                   device) -> DeviceLoader:
    """This process's loader: ``cfg.batch_size`` is the global batch, and
    each of the ``world`` processes loads its ``batch_size // world`` rows
    of it (the JAX ``Trainer._wrap_loader``)."""
    n_proc = process_count()
    if cfg.batch_size % n_proc:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"process count {n_proc}")
    host = HostLoader(dataset, cfg.batch_size // n_proc, shuffle=shuffle,
                      seed=cfg.seed, workers=cfg.workers,
                      process_index=process_index(), process_count=n_proc,
                      transfer_uint8=(cfg.transfer_uint8
                                      and cfg.n_classes <= 255))
    return DeviceLoader(host, device, put_thread=cfg.put_thread)


def step_seed(seed: int, step: int) -> int:
    """The seed of global step ``step``'s random draws."""
    return ((seed & 0xFFFFFFFF) << 31 | (step & 0x7FFFFFFF)) & (2 ** 63 - 1)


def _seeded(seed: int, build: Callable):
    """``build()`` under the global generator seeded with ``seed`` (the
    GridNet and HNED blocks draw their initial weights from it), without
    moving the caller's global stream."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _build_model(cfg: Config, dtype):
    if cfg.arch == "ResnetGenerator":
        return get_model_cls(cfg.arch)(
            input_nc=cfg.model_in_channels, ngf=cfg.ngf, norm=cfg.norm,
            use_dropout=not cfg.no_dropout, init_type=cfg.init_type,
            init_gain=cfg.init_gain, dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed))
    return _seeded(cfg.seed, lambda: get_model_cls(cfg.arch)(
        n_channels=cfg.model_in_channels, dtype=dtype,
        filters_level=tuple(cfg.filters_level), remat=cfg.remat))


class _RolloutModel:
    """A pix2pix generator as the rollout calls a GridNet (it has no
    upsample choice)."""

    def __init__(self, model):
        self.model = model
        self.dtype = model.dtype

    def __call__(self, x, upsample: str = "bilinear"):
        return self.model(x)


class Trainer:
    def __init__(self, cfg: Config, dataset_train=None, dataset_val=None):
        check_options(cfg)
        self.cfg = cfg
        self.mesh = training_mesh(cfg.mesh_shape)
        self.device = resolve_device(cfg.device)
        if cfg.path:
            os.makedirs(cfg.path, exist_ok=True)
        self.logger = get_logger(
            os.path.join(cfg.path, "experiment.log")
            if cfg.path and is_primary() else None)
        self.logger.info("Initializing trainer")
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        dev = self.device

        # --- models ------------------------------------------------------
        self.model = _build_model(cfg, dtype).to(dev)
        self.hned = None
        if cfg.edge:
            self.hned = _seeded(0, lambda: HNED(dtype=dtype))
            if cfg.hed_weights:
                self.hned.load_state_dict(load_hned_params(cfg.hed_weights),
                                          strict=True)
            self.hned.requires_grad_(False).to(dev)

        # --- losses ------------------------------------------------------
        self.combined = CombinedLoss.create(cfg.vgg_weights, dtype,
                                            device=dev)

        # --- optimizer / state ------------------------------------------
        mu_dt = (torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16"
                 and cfg.optimizer == "adam" else None)
        tx = make_optimizer(cfg.optimizer, cfg.lr, cfg.beta1,
                            moment_dtype=mu_dt)
        gen_state = TrainState.create(self.model, tx)
        self._flip_gen = torch.Generator()
        # on the device: WGAN-GP weights, rollout noise, sampling mask
        self._device_gen = (torch.Generator(device=dev) if cfg.gan_train
                            or cfg.multistep_k > 1
                            or cfg.scheduled_sampling > 0 else None)
        if cfg.gan_train:
            self.disc = self._build_discriminator(cfg, dtype).to(dev)
            d_tx = make_optimizer(cfg.optimizer, cfg.lr, cfg.beta1)
            self.state = GanTrainState(gen=gen_state,
                                       disc=TrainState.create(self.disc,
                                                              d_tx))
        else:
            self.disc = None
            self.state = gen_state
        self.epoch = 0
        self.global_step = 0

        # --- checkpointing ----------------------------------------------
        ckpt_dir = os.path.join(cfg.path, "checkpoint") if cfg.path else None
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.warm_start_report = {}   # merge_params' report, by net
        if cfg.ckpt:  # warm-start weights only, key-gated intersection
            self.logger.info("Loading from ckpt %s" % cfg.ckpt)
            tree = CheckpointManager.restore_path(cfg.ckpt)
            self.warm_start_report["generator"] = self._merge(
                self.model.state_dict(keep_vars=True), tree["params"],
                "generator" if cfg.gan_train else "model")
            if cfg.gan_train and "disc_params" in tree:
                self.warm_start_report["discriminator"] = self._merge(
                    self.state.disc.params, tree["disc_params"],
                    "discriminator")
        if cfg.resume:
            self.load_checkpoint(cfg.resume)
        if in_group():
            # every rank builds the kernels before the first collective,
            # then starts from rank 0's parameters
            build_then_barrier(dev)
            nets = [self.model] + ([self.disc] if self.disc is not None
                                   else [])
            replicate([t for net in nets for t in
                       list(net.parameters()) + list(net.buffers())])

        # --- steps -------------------------------------------------------
        kw = dict(w_l1=cfg.w_l1, w_style=cfg.w_style, w_seg=cfg.w_seg,
                  device=dev)
        if cfg.gan_train:
            self._train_step = make_gan_train_step(
                self.model, self.disc, self.hned, self.combined,
                cfg.gan_mode, disc_batch_stats=(self.disc.norm == "batch"),
                generator=self._flip_gen, gp_generator=self._device_gen, **kw)
        elif cfg.multistep_k > 1:
            self._train_step = make_multistep_train_step(
                self.model, self.hned, self.combined, cfg.multistep_k,
                remat_steps=cfg.multistep_remat,
                discount=cfg.multistep_discount,
                feedback_noise=cfg.multistep_feedback_noise,
                layout_noise=cfg.multistep_layout_noise,
                image_weight=cfg.multistep_image_weight,
                image_discount=cfg.multistep_image_discount,
                generator=self._flip_gen, noise_generator=self._device_gen,
                **kw)
        elif cfg.scheduled_sampling > 0:
            ss_step = make_scheduled_train_step(
                self.model, self.hned, self.combined,
                generator=self._flip_gen, noise_generator=self._device_gen,
                **kw)
            self._ss_p = scheduled_p(0, cfg.scheduled_sampling,
                                     cfg.scheduled_ramp)
            # p is read at each call: set_epoch's ramp moves it
            self._train_step = (lambda st, b: ss_step(st, b, self._ss_p))
        else:
            self._train_step = make_train_step(
                self.model, self.hned, self.combined,
                generator=self._flip_gen, **kw)
        self._eval_step = make_eval_step(
            self.model, self.hned, self.combined,
            n_classes=cfg.n_classes, **kw)
        ro_model = (self.model if cfg.arch in ("GridNet", "CoordGridNet")
                    else _RolloutModel(self.model))
        self._rollout = make_rollout_fn(
            ro_model, self.hned, n_frames=cfg.rollout_frames,
            use_edges=cfg.edge, upsample=cfg.rollout_upsample,
            edge_scale=cfg.rollout_edge_scale)

        # --- data --------------------------------------------------------
        if dataset_train is None:
            dataset_train, dataset_val = self._default_datasets()
        if cfg.device_data:
            if not hasattr(dataset_train, "scene_table"):
                raise ValueError("device_data=True needs a dataset exposing "
                                 "scene_table() (synthetic only)")
            if process_count() > 1:
                raise ValueError("device_data is single-process only")
            from ..data.device_synthetic import DeviceSyntheticLoader
            self.train_loader = DeviceSyntheticLoader(
                dataset_train, cfg.batch_size, device=dev, seed=cfg.seed,
                n_frames=getattr(dataset_train, "n_frames", 3))
        else:
            self.train_loader = self._wrap_loader(dataset_train, shuffle=True)
        self.val_loader = self._wrap_loader(dataset_val, shuffle=False)
        # the train loader's HostLoader (None on the device-data path): its
        # count of the batches its workers assembled goes into the epoch line
        self._train_host = getattr(self.train_loader, "loader", None)
        # the GAN step's D forwards by role (None for the other steps): an
        # epoch's count goes into the epoch line too
        self._disc_forwards = getattr(self._train_step, "disc_forwards", None)

        # --- observability ----------------------------------------------
        tb_dir = cfg.path if cfg.path and is_primary() else None
        self.writer = SummaryWriter(tb_dir, enabled=tb_dir is not None)
        self.predict_dir = (os.path.join(cfg.path, "predict")
                            if cfg.path else None)
        self.epoch_stats: Dict[str, float] = {}
        self.logger.debug("Finish init trainer (device=%s, params=%d)" % (
            dev, sum(p.numel() for p in self.model.parameters())))

    # ------------------------------------------------------------------
    @property
    def model_state(self) -> TrainState:
        """The generator's train state in plain and GAN mode."""
        return self.state.gen if self.cfg.gan_train else self.state

    def _merge(self, live: Dict[str, torch.Tensor], restored, tag: str):
        merged, rep = merge_params(live, restored)
        self.logger.info(
            "%s warm start: %d loaded, %d missing (kept init), "
            "%d unexpected, %d shape-mismatched", tag,
            len(rep["loaded"]), len(rep["missing"]),
            len(rep["unexpected"]), len(rep["shape_mismatch"]))
        for kind in ("missing", "unexpected", "shape_mismatch"):
            for p in rep[kind]:
                self.logger.info("  %s: %s", kind, p)
        if not rep["loaded"]:
            raise ValueError(
                f"ckpt {self.cfg.ckpt} shares no parameters with the "
                f"live {self.cfg.arch} model")
        copy_into(live, merged)
        return rep

    @staticmethod
    def _build_discriminator(cfg: Config, dtype):
        from ..models import NLayerDiscriminator, PixelDiscriminator
        kw = dict(norm=cfg.norm, init_type=cfg.init_type,
                  init_gain=cfg.init_gain, dtype=dtype,
                  generator=torch.Generator().manual_seed(cfg.seed + 1))
        if cfg.netD == "basic":
            return NLayerDiscriminator(9, cfg.ndf, n_layers=3, **kw)
        if cfg.netD == "n_layers":
            return NLayerDiscriminator(9, cfg.ndf, n_layers=cfg.n_layers_D,
                                       **kw)
        if cfg.netD == "pixel":
            return PixelDiscriminator(9, cfg.ndf, **kw)
        raise ValueError(f"unknown netD {cfg.netD!r}")

    def _default_datasets(self):
        from ..data import get_dataset
        return get_dataset(self.cfg)

    def _wrap_loader(self, dataset, shuffle: bool) -> DeviceLoader:
        return sharded_loader(self.cfg, dataset, shuffle, self.device)

    def _seed_step(self, step: int):
        """Reseed the step's generators for global step ``step``."""
        s = step_seed(self.cfg.seed, step)
        self._flip_gen.manual_seed(s)
        if self._device_gen is not None:
            self._device_gen.manual_seed(s)

    # ------------------------------------------------------------------
    def set_epoch(self, epoch: int):
        self.logger.info("Start of epoch %d" % (epoch + 1))
        self.epoch = epoch + 1
        self.train_loader.set_epoch(epoch)
        self.val_loader.set_epoch(epoch)
        cfg = self.cfg
        if cfg.scheduled_sampling > 0:
            self._ss_p = scheduled_p(epoch, cfg.scheduled_sampling,
                                     cfg.scheduled_ramp)
        lr = None
        # pix2pix scheduler policies
        if cfg.lr_policy == "linear":
            from .schedules import linear_lr
            lr = linear_lr(cfg.lr, epoch, cfg.epoch_count, cfg.niter,
                           cfg.niter_decay)
        elif cfg.lr_policy == "step":
            from .schedules import step_lr
            lr = step_lr(cfg.lr, epoch, cfg.lr_decay_iters)
        elif cfg.lr_policy == "cosine":
            from .schedules import cosine_lr
            lr = cosine_lr(cfg.lr, epoch, cfg.niter)
        elif cfg.optimizer == "sgd":  # staircase decay
            lr = epoch_decayed_lr(cfg.lr, epoch, cfg.lr_decay_step,
                                  cfg.lr_decay_gamma)
        if lr is not None:
            self._apply_lr(lr)

    def _apply_lr(self, lr: float):
        if self.cfg.gan_train:
            set_lr(self.state.gen, lr)
            set_lr(self.state.disc, lr)
        else:
            set_lr(self.state, lr)
        self.writer.add_scalar("other/lr-epoch", current_lr(self.model_state),
                               self.epoch)

    def train(self):
        self.logger.info("Training started")
        cfg = self.cfg
        timer = StepTimer()
        t0 = time.perf_counter()
        load_s = comp_s = 0.0
        n_batches = len(self.train_loader)
        metrics = None
        d_before = dict(self._disc_forwards or {})
        g_before = dict(GROUPED)
        batches = iter(self.train_loader)
        for i in itertools.count():
            with annotate("train.load"):
                batch = next(batches, None)
            if batch is None:
                break
            timer.mark_loaded()
            load_s += timer.load_time
            self.global_step += 1
            self._seed_step(self.global_step)
            with annotate("train.step"):
                self.state, metrics = self._train_step(self.state, batch)
            if i % cfg.print_freq == 0:
                with annotate("train.log"):
                    self._log_step(i, n_batches, metrics, batch, timer)
            else:
                timer.mark_computed()
            comp_s += timer.comp_time
        # epoch end: one fetch, so that every queued step has run
        if metrics is not None:
            float(metrics["loss"])
        self._end_epoch(n_batches, time.perf_counter() - t0, load_s, comp_s,
                        d_before, g_before)

    def _log_step(self, i: int, n_batches: int, metrics, batch,
                  timer: StepTimer):
        """The logged step's line, scalars and images: the host waits for
        the card only here."""
        cfg = self.cfg
        loss = float(metrics["loss"])
        timer.mark_computed()
        self.logger.info(
            "Epoch [%d/%d][%d/%d] load [%.3fs] comp [%.3fs] "
            "loss [%.4f]" % (self.epoch, cfg.epochs, i + 1, n_batches,
                             timer.load_time, timer.comp_time, loss))
        self.writer.add_scalar("train/loss", loss, self.global_step)
        for k in ("loss_l1", "loss_style", "loss_seg", "loss_gan", "loss_d"):
            if k in metrics:
                self.writer.add_scalar(f"train/{k}", float(metrics[k]),
                                       self.global_step)
        if "loss_per_step" in metrics:
            self._log_per_step(metrics["loss_per_step"])
        if self.writer.active and i % max(cfg.disp_interval, 1) == 0:
            self._log_train_images(batch)

    def _end_epoch(self, steps: int, wall: float, load_s: float,
                   comp_s: float, d_before: Dict[str, int],
                   g_before: Dict[str, int]):
        self.epoch_stats = dict(steps=steps, wall_s=wall, load_s=load_s,
                                comp_s=comp_s,
                                samples=steps * self.cfg.batch_size)
        extra = ""
        if self._train_host is not None:
            by = self._train_host.assembled
            self.epoch_stats.update(assembled_by_workers=by["workers"],
                                    assembled_on_consumer=by["consumer"])
            extra = (", batches assembled by the loader's workers %d, "
                     "on its consumer's thread %d" % (by["workers"],
                                                      by["consumer"]))
        if self._disc_forwards is not None:
            moved = {role: n - d_before[role]
                     for role, n in self._disc_forwards.items()}
            self.epoch_stats.update({f"disc_forwards_{role}": n
                                     for role, n in moved.items()})
            extra += ", D forwards %s" % " ".join(
                "%s %d" % kv for kv in moved.items())
        # the epoch's grouped optimizer updates (``state.GROUPED``)
        upd = {k: n - g_before[k] for k, n in GROUPED.items()}
        self.epoch_stats.update({f"optimizer_{k}": n for k, n in upd.items()})
        extra += (", optimizer updates %d over %d tensors in %d groups"
                  % (upd["updates"], upd["tensors"], upd["groups"]))
        rate = self.epoch_stats["samples"] / max(wall, 1e-9)
        self.logger.info(
            "Epoch [%d/%d] %d steps in %.3fs (load %.3fs, comp %.3fs), "
            "%.1f samples/s%s" % (self.epoch, self.cfg.epochs, steps, wall,
                                  load_s, comp_s, rate, extra))
        self.logger.debug("epoch drained at step %d" % self.model_state.step)

    def _log_per_step(self, per_step: torch.Tensor):
        """The K-step loss's terms summed for each rollout step."""
        vals = per_step.tolist()
        self.logger.info("loss per rollout step [%s]"
                         % " ".join("%.4f" % v for v in vals))
        for j, v in enumerate(vals):
            self.writer.add_scalar(f"train/loss_step{j + 1}", v,
                                   self.global_step)

    def _log_train_images(self, batch):
        """TensorBoard grids: GT frame, generated frame, GT and predicted
        layouts (colorized), and the generated frame's edge map; a window
        batch shows its first triplet."""
        if is_window_batch(batch):
            batch = window_to_triplet_batch(batch)
        _, seg_ids, img_n = self._eval_step(batch)
        batch = decode_batch(batch)
        step = self.global_step
        n = self.cfg.n_classes
        self.writer.add_image("train/img gt", batch["img3"], step)
        self.writer.add_image("train/img", denormalize_image(img_n), step)
        self.writer.add_image("train/seg gt", colorize_seg(batch["seg3"], n),
                              step)
        self.writer.add_image("train/seg", colorize_seg(seg_ids, n), step)
        if self.hned is not None:
            with torch.no_grad():
                edge = self.hned(denormalize_image(img_n))[-1]
            self.writer.add_image("train/edge", edge.repeat(1, 1, 1, 3),
                                  step)

    def validate(self) -> Dict[str, object]:
        """Validation epoch: size-weighted loss and confusion-matrix totals,
        summed on the device and fetched once (the module's ``validate``);
        every 100th batch is dumped to ``predict/``."""
        self.logger.info("Validation started")
        cfg = self.cfg
        dump = None
        if self.predict_dir:
            def dump(i, batch, seg_ids, img_n):
                if i % 100 == 0:
                    self._dump_val_stack(batch, seg_ids, img_n, i)
        out = validate(self._eval_step, self.val_loader, cfg.n_classes,
                       on_batch=dump)
        if np.isnan(out["loss"]):
            self.logger.info("Validation loader produced no batches")
            return out
        self.logger.info(
            "Epoch [%d/%d] loss [%.4f] mIoU [%.4f] pixAcc [%.4f]" % (
                self.epoch, cfg.epochs, out["loss"], out["miou"],
                out["pixel_acc"]))
        self.writer.add_scalar("val/loss", out["loss"], self.epoch)
        self.writer.add_scalar("val/miou", out["miou"], self.epoch)
        self.writer.add_scalar("val/pixel_acc", out["pixel_acc"], self.epoch)
        return out

    def _dump_val_stack(self, batch, seg_ids, img_n, i: int):
        """Inputs and prediction as one 16-channel stack: normalized frames
        1-3, the normalized prediction, seg1, seg2, seg3 and the predicted
        layout."""
        b = decode_batch(batch)
        stack = torch.cat([
            normalize_image(b["img1"]), normalize_image(b["img2"]),
            normalize_image(b["img3"]), img_n, b["seg1"], b["seg2"],
            b["seg3"].float()[..., None], seg_ids.float()[..., None],
        ], dim=-1)
        if in_group():      # every rank's rows, in rank order
            parts = [torch.empty_like(stack) for _ in range(process_count())]
            torch.distributed.all_gather(parts, stack.contiguous())
            stack = torch.cat(parts)
        if is_primary():
            save_npy_stack(self.predict_dir,
                           f"val_{time.time():.0f}_{i:06d}",
                           {"stack": stack})

    # ------------------------------------------------------------------
    def save_checkpoint(self, metrics: Optional[Dict] = None):
        if self.ckpt is None or not is_primary():
            return
        self.logger.info("Saving checkpoint..")
        extra = None
        if self.cfg.gan_train:
            extra = {"disc_params": self.state.disc.params,
                     "disc_opt_state": self.state.disc.opt_state}
            if self.state.disc_stats is not None:
                extra["disc_stats"] = self.state.disc_stats
        self.ckpt.save(self.epoch, self.model.state_dict(),
                       self.model_state.opt_state, self.global_step,
                       self.cfg.arch, extra=extra)

    def load_checkpoint(self, resume: str):
        """Restore epoch, step, weights and optimizer state in place."""
        self.logger.info("Resuming checkpoint %s" % resume)
        if resume == "latest" and self.ckpt is not None:
            resume = os.path.join(self.ckpt.directory, "latest")
        tree = CheckpointManager.restore_path(resume, arch=self.cfg.arch)
        self.epoch = int(tree["epoch"])
        self.global_step = int(tree.get("step", 0))
        gen = self.model_state
        restore_opt_state(gen.opt_state, tree["opt_state"])
        copy_into(self.model.state_dict(keep_vars=True), tree["params"])
        gen.step = self.global_step
        if self.cfg.gan_train and "disc_params" in tree:
            disc = self.state.disc
            restore_opt_state(disc.opt_state, tree["disc_opt_state"])
            copy_into(disc.params, tree["disc_params"])
            stats = self.state.disc_stats
            if stats is not None:
                copy_into(stats, tree["disc_stats"])
            disc.step = self.global_step
        self.logger.info("Checkpoint loaded")

    # ------------------------------------------------------------------
    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device, torch.float32)

    def generate_sequence(self, img1, img2, seg1, seg2, save: bool = True):
        """Rollout from normalized (N,H,W,3) frames and (N,H,W,1) layouts
        (tensors or arrays); returns (imgs, segs) on the device."""
        img1, img2, seg1, seg2 = map(self._on_device,
                                     (img1, img2, seg1, seg2))
        with torch.inference_mode():
            imgs, segs = self._rollout(img1, img2, seg1, seg2)
        if save and self.predict_dir and is_primary():
            full_imgs = torch.cat([img1[:, None], img2[:, None], imgs], 1)
            full_segs = torch.cat([seg1[:, None], seg2[:, None], segs], 1)
            save_npy_stack(self.predict_dir, f"val_{time.time():.0f}",
                           {"img": full_imgs, "seg": full_segs})
        return imgs, segs

    def eval_rollout_fidelity(self):
        """Per-step rollout fidelity on fixed held-out synthetic scenes
        (seed 4242), logged during training."""
        cfg = self.cfg
        if cfg.dataset != "synthetic":
            self.logger.info("rollout fidelity tracking needs the "
                             "synthetic dataset (sequence() contract); "
                             "skipping")
            return None
        from ..data.synthetic import SyntheticTriplets
        from ..evaluation.sequence import evaluate_trainer_rollout
        n = cfg.rollout_fidelity_scenes
        ds = SyntheticTriplets(n, cfg.image_size, cfg.n_classes, seed=4242)
        fid = evaluate_trainer_rollout(self, ds, list(range(n)),
                                       n_frames=cfg.rollout_frames)
        curve = " ".join(f"{float(v):.4f}" for v in fid["per_step_miou"])
        self.logger.info("Rollout fidelity mean [%.4f] per-step [%s]" % (
            fid["mean_miou"], curve))
        self.writer.add_scalar("val/rollout_fidelity_mean",
                               fid["mean_miou"], self.epoch)
        for k, v in enumerate(fid["per_step_miou"]):
            self.writer.add_scalar("val/rollout_fidelity_step%d" % (k + 1),
                                   float(v), self.epoch)
        return fid

    def eval_generate_sequence(self, img1_path: str, img2_path: str,
                               seg1_path: str, seg2_path: str):
        """Rollout from image paths: two RGB frames and their layouts."""
        from ..data.cityscapes import _load_rgb, _load_seg
        hw = self.cfg.image_size
        try:
            i1 = _load_rgb(img1_path, hw)
            i2 = _load_rgb(img2_path, hw)
            s1 = _load_seg(seg1_path, hw)
            s2 = _load_seg(seg2_path, hw)
        except FileNotFoundError:
            self.logger.debug("path name not exists")
            return None
        img1 = normalize_image(self._on_device(i1))[None]
        img2 = normalize_image(self._on_device(i2))[None]
        seg1 = self._on_device(s1)[None, ..., None]
        seg2 = self._on_device(s2)[None, ..., None]
        return self.generate_sequence(img1, img2, seg1, seg2)

    # ------------------------------------------------------------------
    def fit(self):
        """The training run: ``epochs`` epochs from the restored one, each
        train -> validate (every ``val_interval``) -> rollout fidelity
        (every ``rollout_fidelity_every``) -> checkpoint."""
        plateau = None
        if self.cfg.lr_policy == "plateau":
            from .schedules import PlateauScheduler
            plateau = PlateauScheduler(self.cfg.lr)
        metrics = {}
        # self.epoch counts completed epochs (0 fresh, restored on resume):
        # it is also the 0-indexed id of the next epoch to run
        for epoch in range(self.epoch, self.cfg.epochs):
            self.set_epoch(epoch)
            self.train()
            if (epoch + 1) % max(self.cfg.val_interval, 1) == 0:
                metrics = self.validate()
                if plateau is not None:
                    self._apply_lr(plateau.update(metrics["loss"]))
            if (self.cfg.rollout_fidelity_every > 0
                    and (epoch + 1) % self.cfg.rollout_fidelity_every == 0):
                self.eval_rollout_fidelity()
            self.save_checkpoint(metrics)
        return metrics
