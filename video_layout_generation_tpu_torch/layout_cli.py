"""Training CLI of the layout-only families, VAE / CVAE / ConvLSTM (the JAX
package's ``layout_cli.py``): the same flags, plus ``--device`` (default
``cuda``; ``cpu`` runs on the CPU).

  python -m video_layout_generation_tpu_torch.layout_cli --family cvae \\
      --dataset synthetic -e 3 -bs 8 --size 64 [--device cpu]

Under ``torchrun`` (one process a card) every process joins the group
first and trains its rows of each global batch of ``-bs``.
"""

from __future__ import annotations

import argparse
import pathlib

from .config import Config, default_exp_path
from .parallel.mesh import maybe_initialize_distributed


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a layout-only model")
    p.add_argument("--family", choices=["vae", "cvae", "convlstm"],
                   default="cvae")
    p.add_argument("-d", "--dataset", default="synthetic",
                   choices=["cityscape", "synthetic"])
    p.add_argument("--train_dir", default="/data/train")
    p.add_argument("--val_dir", default="/data/val")
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("-e", "--epochs", type=int, default=3)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--n_classes", type=int, default=20)
    p.add_argument("--latent_dim", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kl_warmup", type=int, default=500)
    p.add_argument("--beta_max", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("-p", "--path", default=None)
    p.add_argument("--synthetic_train_size", type=int, default=64)
    p.add_argument("--synthetic_val_size", type=int, default=16)
    p.add_argument("--rollout_frames", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="where the run goes: 'cuda' or 'cpu'")
    return p


def build_trainer(argv=None):
    """The ``LayoutTrainer`` of a command line, its experiment directory
    made."""
    args = build_arg_parser().parse_args(argv)
    maybe_initialize_distributed(args.device)
    cfg = Config(
        dataset=args.dataset, train_dir=args.train_dir,
        val_dir=args.val_dir, batch_size=args.batch_size,
        epochs=args.epochs, image_size=(args.size, args.size),
        n_classes=args.n_classes, lr=args.lr, seed=args.seed,
        path=args.path or default_exp_path(),
        synthetic_train_size=args.synthetic_train_size,
        synthetic_val_size=args.synthetic_val_size,
        rollout_frames=args.rollout_frames, edge=False, device=args.device)
    pathlib.Path(cfg.path).mkdir(parents=True, exist_ok=True)

    from .train.layout_trainer import LayoutTrainer
    return LayoutTrainer(cfg, family=args.family,
                         latent_dim=args.latent_dim, hidden=args.hidden,
                         kl_warmup_steps=args.kl_warmup,
                         beta_max=args.beta_max)


def run(trainer) -> dict:
    """``fit``, then print the final validation's scalars; returns them."""
    metrics = trainer.fit()
    print({k: (round(float(v), 4) if not hasattr(v, "shape") else "...")
           for k, v in metrics.items()})
    return metrics


def main(argv=None) -> dict:
    return run(build_trainer(argv))


if __name__ == "__main__":
    main()
