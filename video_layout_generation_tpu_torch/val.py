"""Legacy layout-completion evaluation CLI (the JAX package's ``val.py``):
the same flags, plus ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU, and without a card ``cuda`` raises).

A masked layout-completion model (``Simple`` with the ``u_net`` or the
``encoder_decoder`` backbone, ``models/legacy.py``) runs over the eval set
in batches; each batch's argmax is fetched once, as int32 ids, its
confusion matrix is counted on the device, and each image is saved as a
colorized PNG (``--nw`` threads). Printed: per-batch eval cost, per-class
IoU, mIoU and pixel accuracy, as the JAX CLI prints them.

- Data: ``--data`` names an npz with ``imgs (N,H,W,3)``, ``segs (N,H,W)``
  and ``masks (N,H,W)`` (mask 1 = cropped, to complete); without it a
  synthetic masked-layout set at ``--size`` (the reference's eval contract
  is 1024 2048, src/val.py:176).
- Weights: ``--ckpt`` is a checkpoint of the port (a directory holding
  ``checkpoint.pt``, or the file) or a flat npz of the flax variables
  (``params/...`` and ``batch_stats/...``), resolved under ``--load_dir``
  when relative and not found. The ``u_net`` backbone's BatchNorm
  evaluates with its running statistics, so a checkpoint without the
  ``batch_stats`` collection raises. Without ``--ckpt`` the weights are
  drawn from a generator seeded with 0 (not the JAX CLI's
  ``jax.random.key(0)`` draw).
- Precision: f32 tensors. The convs are the library's; on the card they
  run in whatever ``torch.backends.cudnn.allow_tf32`` says, which the CLI
  leaves at PyTorch's default (True: TF32 tensor cores), as the port's
  other f32 paths do.
- ``--data_parallel``: a one-process mesh of the process's cards
  (``parallel/mesh.py:make_mesh``), a replica of the model on each and a
  slice of each batch for each; the batch size must be divisible by the
  mesh size. The eval reads BatchNorm's running statistics, so nothing
  crosses devices but the ids.

Usage:
  python -m video_layout_generation_tpu_torch.val --model u_net --bs 4 \\
      [--data arrays.npz] [--ckpt <checkpoint>] [--save_dir results] \\
      [--size 1024 2048] [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import copy
import hashlib
import os
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .evaluation.export import save_colorized_png
from .evaluation.metrics import confusion_matrix, summarize_confusion
from .io.checkpoint import CheckpointManager
from .models.legacy import Simple
from .parallel.mesh import make_mesh, shard_batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a segmentation completion network")
    p.add_argument("--dataset", choices=["cityscape", "synthetic"],
                   default="synthetic")
    p.add_argument("--model", choices=["u_net", "encoder_decoder"],
                   default="u_net")
    p.add_argument("--data", type=str, default=None,
                   help="npz with imgs/segs/masks arrays")
    p.add_argument("--load_dir", type=str, default="models",
                   help="directory a relative --ckpt is resolved under")
    p.add_argument("--save_dir", type=str, default="results")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint of the port, or a flat npz of the flax "
                        "params and batch_stats")
    p.add_argument("--nw", dest="num_workers", type=int, default=0,
                   help="threads for the PNG export")
    p.add_argument("--bs", dest="batch_size", type=int, default=1)
    p.add_argument("--n_classes", type=int, default=29)
    p.add_argument("--size", type=int, nargs="+", default=[256],
                   help="synthetic eval resolution: SIZE or H W (the "
                        "reference's eval contract is 1024 2048, "
                        "src/val.py:176)")
    p.add_argument("--n_samples", type=int, default=8,
                   help="synthetic sample count")
    p.add_argument("--embedding_dim", type=int, default=15)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard each eval batch over all devices (the "
                        "reference's optional nn.DataParallel, "
                        "src/val.py:130-131)")
    p.add_argument("--device", default="cuda",
                   help="where the eval runs: 'cuda' or 'cpu'")
    return p.parse_args(argv)


def _synthetic_arrays(n, shape, n_classes, seed=0):
    hh, ww = shape
    rng = np.random.default_rng(seed)
    segs = np.zeros((n, hh, ww), np.int32)
    for i in range(n):
        for _ in range(5):
            c = int(rng.integers(0, n_classes))
            y0 = int(rng.integers(0, hh - 8))
            x0 = int(rng.integers(0, ww - 8))
            h = int(rng.integers(8, hh // 2))
            w = int(rng.integers(8, ww // 2))
            segs[i, y0:y0 + h, x0:x0 + w] = c
    imgs = rng.random((n, hh, ww, 3)).astype(np.float32)
    masks = np.zeros((n, hh, ww), np.float32)
    for i in range(n):
        y0 = int(rng.integers(hh // 4, hh // 2))
        x0 = int(rng.integers(ww // 4, ww // 2))
        masks[i, y0:y0 + hh // 4, x0:x0 + ww // 4] = 1.0
    return imgs, segs, masks


def load_completion_weights(model: Simple, ckpt: str) -> None:
    """Load both collections of a checkpoint into ``model`` (parameters
    and BatchNorm buffers, strictly)."""
    state = CheckpointManager.restore_path(ckpt)["params"]
    stats = [name for name, _ in model.named_buffers() if name not in state]
    if stats:
        raise ValueError(
            f"checkpoint {ckpt} has no batch_stats collection (the "
            f"BatchNorm running statistics, {len(stats)} missing, e.g. "
            f"{stats[0]}); the {model.model_name} backbone evaluates with "
            f"them: save the variables' batch_stats beside their params")
    model.load_state_dict(state, strict=True)


@torch.inference_mode()
def _predict(replicas, shards):
    """Argmax ids (int32) of each shard, on its device."""
    return [model(sh["mask"], sh["seg"], sh["img"]).argmax(-1).to(
        torch.int32) for model, sh in zip(replicas, shards)]


def _confusion(preds, shards, n_classes):
    """The batch's confusion matrix, counted on each shard's device and
    summed on the first."""
    parts = [confusion_matrix(p, sh["seg"], n_classes).to(preds[0].device)
             for p, sh in zip(preds, shards)]
    return sum(parts[1:], parts[0])


def main(argv=None) -> dict:
    """Run the eval; returns ``iou``, ``miou``, ``pixel_acc``, the seconds
    of each batch's ``eval_s`` (upload, forward, argmax, fetch),
    ``draw_s`` (confusion matrix) and ``save_s`` (PNGs), and
    ``ids_sha256``, the SHA-256 of every predicted id in order (int32)."""
    args = parse_args(argv)
    print("Called with args:")
    print(args)

    device = resolve_device(args.device)
    size = tuple(args.size) if len(args.size) == 2 else (args.size[0],) * 2
    if args.data:
        with np.load(args.data) as raw:
            imgs, segs, masks = (np.asarray(raw["imgs"], np.float32),
                                 np.asarray(raw["segs"], np.int32),
                                 np.asarray(raw["masks"], np.float32))
    else:
        imgs, segs, masks = _synthetic_arrays(args.n_samples, size,
                                              args.n_classes)
    n = imgs.shape[0]
    if n % args.batch_size != 0:
        raise SystemExit(
            f"batch size must divide val size ({n})")

    model = Simple(args.n_classes, args.embedding_dim, args.model,
                   generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        ckpt = args.ckpt
        if not os.path.isabs(ckpt) and not os.path.exists(ckpt):
            ckpt = os.path.join(args.load_dir, ckpt)
        load_completion_weights(model, ckpt)

    mesh = None
    devices = [device]
    if args.data_parallel:
        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
        if args.batch_size % mesh.size != 0:
            raise SystemExit(f"batch size {args.batch_size} must be "
                             f"divisible by the device count {mesh.size}")
        devices = [resolve_device(d) for d in mesh.devices]
    model.to(devices[0]).eval()
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]

    save_folder = os.path.join(args.save_dir,
                               f"{args.model}_eval_{size[0]}x{size[1]}")
    os.makedirs(save_folder, exist_ok=True)

    print("evaluation start")
    sys.stdout.flush()
    pool = (cf.ThreadPoolExecutor(args.num_workers)
            if args.num_workers > 0 else None)
    cm_total = None
    img_count = 0
    times = {"eval_s": [], "draw_s": [], "save_s": []}
    ids_hash = hashlib.sha256()
    try:
        for step in range(n // args.batch_size):
            sl = slice(step * args.batch_size, (step + 1) * args.batch_size)
            batch = {"mask": masks[sl], "seg": segs[sl], "img": imgs[sl]}
            tic = time.time()
            shards = (shard_batch(batch, mesh) if mesh is not None else
                      [{k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()}])
            preds = _predict(replicas, shards)
            pred_np = torch.cat([p.cpu() for p in preds]).numpy()
            # full-resolution output contract (reference src/val.py:176
            # asserts [bs, 1024, 2048])
            if pred_np.shape != segs[sl].shape:
                raise RuntimeError(f"prediction shape {pred_np.shape}, "
                                   f"expected {segs[sl].shape}")
            eval_time = time.time() - tic

            tic = time.time()
            cm = _confusion(preds, shards, args.n_classes)
            cm_total = cm if cm_total is None else cm_total + cm
            draw_time = time.time() - tic

            tic = time.time()
            paths = [os.path.join(save_folder, f"{img_count + i}.png")
                     for i in range(args.batch_size)]
            if pool is not None:
                list(pool.map(save_colorized_png, paths, pred_np))
            else:
                for path, pr in zip(paths, pred_np):
                    save_colorized_png(path, pr)
            img_count += args.batch_size
            save_time = time.time() - tic
            for key, t in zip(times, (eval_time, draw_time, save_time)):
                times[key].append(t)
            ids_hash.update(pred_np.tobytes())
            sys.stdout.write(
                "\rsaving image {}/{} \ttime cost: {:.2f}\teval cost: {:.2f}"
                .format(img_count, n, eval_time + draw_time + save_time,
                        eval_time))
            sys.stdout.flush()
    finally:
        if pool is not None:
            pool.shutdown()

    iou, miou, acc = summarize_confusion(cm_total, args.n_classes)
    print("\nper-class IoU:",
          " ".join("%.3f" % v if np.isfinite(v) else "nan" for v in iou))
    print(f"mIoU: {miou:.4f}  pixel-acc: {acc:.4f}")
    return dict(iou=iou, miou=miou, pixel_acc=acc,
                ids_sha256=ids_hash.hexdigest(), **times)


if __name__ == "__main__":
    main()
