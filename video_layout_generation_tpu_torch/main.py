"""Training and evaluation CLI of the port (the JAX package's ``main.py``).

The JAX package's flag names, plus ``--device`` (default ``cuda``; ``cpu``
runs every kernel's plain version), and its three modes: the rollout from
two image paths and their layouts, validation only, or the training loop.
Launched by ``torchrun`` (one process a card), every process joins the
group first and trains its rows of each global batch of ``-bs``.

Usage:
  python -m video_layout_generation_tpu_torch.main --train_dir ... \
      --val_dir ...
  python -m video_layout_generation_tpu_torch.main --dataset synthetic -e 2
  torchrun --nproc_per_node 4 -m video_layout_generation_tpu_torch.main \
      --dataset synthetic -bs 64 --mesh_shape 4
  python -m video_layout_generation_tpu_torch.main --img1 a.png \
      --img2 b.png --seg1 c.png --seg2 d.png --ckpt <checkpoint>
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import torch

from .config import Config, config_from_args, default_exp_path
from .io.logging import get_logger
from .parallel.mesh import is_primary, maybe_initialize_distributed


def device_line(cfg: Config) -> str:
    """The device the run uses: the CUDA card's name, or ``cpu``."""
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return "Device: %s (%s)" % (dev, torch.cuda.get_device_name(dev))
    return "Device: %s" % dev


def build_trainer(cfg: Config):
    """Experiment directory, logger and ``Trainer`` of a run."""
    if cfg.path is None:
        cfg = cfg.replace(path=default_exp_path())
    pathlib.Path(cfg.path, "checkpoint").mkdir(parents=True, exist_ok=True)

    logger = get_logger(os.path.join(cfg.path, "experiment.log")
                        if is_primary() else None)
    logger.info("Start of experiment")
    logger.info("=========== Initialized logger =============")
    logger.info("\n\t" + "\n\t".join(
        "%s: %s" % (k, v)
        for k, v in sorted(dataclasses.asdict(cfg).items())))
    logger.info(device_line(cfg))

    from .train.trainer import Trainer
    return Trainer(cfg)


def run_trainer(trainer):
    """Run the mode the trainer's config names; returns its result: the
    rollout's (frames, layouts), or the validation metrics."""
    cfg = trainer.cfg
    if all(v is not None for v in (cfg.img1, cfg.img2, cfg.seg1, cfg.seg2)):
        return trainer.eval_generate_sequence(cfg.img1, cfg.img2, cfg.seg1,
                                              cfg.seg2)
    if cfg.validate:
        return trainer.validate()
    return trainer.fit()


def run(cfg: Config):
    return run_trainer(build_trainer(cfg))


def main(argv=None):
    cfg = config_from_args(argv)
    maybe_initialize_distributed(cfg.device)
    return run(cfg)


if __name__ == "__main__":
    main()
