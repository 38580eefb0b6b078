"""Rollout fidelity (the JAX package's ``evaluation/sequence.py``): per-step
mIoU and pixel accuracy of the autoregressive rollout against ground-truth
future layouts, for the main ``Trainer``'s rollout
(``evaluate_trainer_rollout``) and for the layout families'
(``evaluate_layout_rollout``)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .metrics import confusion_matrix, iou_from_confusion, pixel_accuracy


def rollout_fidelity(pred_segs, gt_segs, n_classes: int = 20
                     ) -> Dict[str, np.ndarray]:
    """pred_segs: (N, T, H, W[, 1]) predicted layout ids (float ok);
    gt_segs: (N, T, H, W) ground-truth ids. Per-step mIoU and pixel
    accuracy over the steps both hold, and their means."""
    pred = torch.as_tensor(pred_segs)
    if pred.ndim == 5:
        pred = pred[..., 0]
    pred = pred.long()
    gt = torch.as_tensor(gt_segs).to(pred.device).long()
    t = min(pred.shape[1], gt.shape[1])
    mious, accs = [], []
    for k in range(t):
        cm = confusion_matrix(pred[:, k], gt[:, k], n_classes)
        _, miou = iou_from_confusion(cm)
        mious.append(miou)
        accs.append(pixel_accuracy(cm))
    return {
        "per_step_miou": np.asarray(mious),
        "per_step_pixel_acc": np.asarray(accs),
        "mean_miou": float(np.mean(mious)),
        "mean_pixel_acc": float(np.mean(accs)),
    }


def evaluate_trainer_rollout(trainer, dataset, indices: Sequence[int],
                             n_frames: int) -> Dict[str, np.ndarray]:
    """Roll the trainer's model out from each sample's first two frames and
    score it against the dataset's ground-truth future (the dataset exposes
    ``sequence(index, n)``, as the synthetic one does)."""
    from ..train.assemble import normalize_image

    imgs1, imgs2, segs1, segs2, gts = [], [], [], [], []
    for i in indices:
        imgs, segs = dataset.sequence(int(i), n_frames + 2)
        if segs.shape[0] < n_frames + 2:
            raise ValueError(
                f"dataset.sequence returned {segs.shape[0]} frames; "
                f"need {n_frames + 2} (2 seeds + {n_frames} futures)")
        imgs1.append(imgs[0])
        imgs2.append(imgs[1])
        segs1.append(segs[0])
        segs2.append(segs[1])
        gts.append(segs[2:])
    dev = trainer.device

    def up(a, dtype=torch.float32):
        return torch.from_numpy(np.stack(a)).to(dev, dtype)

    img1 = normalize_image(up(imgs1))
    img2 = normalize_image(up(imgs2))
    seg1 = up(segs1)[..., None]
    seg2 = up(segs2)[..., None]
    _, pred_segs = trainer.generate_sequence(img1, img2, seg1, seg2,
                                             save=False)
    return rollout_fidelity(pred_segs, np.stack(gts),
                            trainer.cfg.n_classes)


def evaluate_layout_rollout(trainer, dataset, indices: Sequence[int],
                            n_frames: int) -> Dict[str, np.ndarray]:
    """Rollout fidelity of a ``LayoutTrainer``'s autoregressive family:
    continue from each sample's first two ground-truth layouts for
    ``n_frames`` and score every step against the ground-truth future. The
    CVAE samples its learned prior each step (noise from a generator on the
    trainer's device seeded with ``cfg.seed + 2``), the ConvLSTM feeds its
    argmax back; the VAE family raises ``ValueError``."""
    from ..models.vae import make_cvae_rollout
    from ..ops.one_hot import seg_one_hot

    if trainer.family not in ("cvae", "convlstm"):
        raise ValueError(
            f"rollout fidelity needs an autoregressive family "
            f"(cvae/convlstm), got {trainer.family!r}")
    segs1, segs2, gts = [], [], []
    for i in indices:
        _, segs = dataset.sequence(int(i), n_frames + 2)
        if segs.shape[0] < n_frames + 2:
            raise ValueError(
                f"dataset.sequence returned {segs.shape[0]} frames; "
                f"need {n_frames + 2} (2 seeds + {n_frames} futures)")
        segs1.append(segs[0])
        segs2.append(segs[1])
        gts.append(segs[2:])
    dev = trainer.device
    s1 = torch.from_numpy(np.stack(segs1)).to(dev).long()
    s2 = torch.from_numpy(np.stack(segs2)).to(dev).long()
    n_cls = trainer.cfg.n_classes
    if trainer.family == "cvae":
        gen = torch.Generator(device=dev).manual_seed(trainer.cfg.seed + 2)
        pred = make_cvae_rollout(trainer.model, n_frames, n_cls)(s1, s2, gen)
    else:
        with torch.inference_mode():
            pred = trainer.model.rollout(
                seg_one_hot(torch.stack([s1, s2], 1), n_cls), n_frames)
    return rollout_fidelity(pred, np.stack(gts), n_cls)
