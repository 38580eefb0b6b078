"""Layout quality metrics: per-class IoU and pixel accuracy (the JAX
package's ``evaluation/metrics.py``). The confusion matrix is counted on
the tensors' device and accumulated over batches; IoU and accuracy derive
from it on the host."""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """pred/target (..., H, W) integer ids in [0, n_classes). Returns the
    (C, C) f32 counts [target, pred]."""
    idx = target.reshape(-1).long() * n_classes + pred.reshape(-1).long()
    counts = torch.bincount(idx, minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes).float()


def _np(cm) -> np.ndarray:
    if isinstance(cm, torch.Tensor):
        cm = cm.detach().cpu().numpy()
    return np.asarray(cm, np.float64)


def iou_from_confusion(cm):
    """(per_class_iou (C,), mean_iou). Classes absent from both pred and
    target get NaN and are left out of the mean."""
    cm = _np(cm)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    mean = np.nanmean(iou) if np.any(denom > 0) else 0.0
    return iou, float(mean)


def pixel_accuracy(cm) -> float:
    cm = _np(cm)
    total = cm.sum()
    return float(np.diag(cm).sum() / total) if total else 0.0


def summarize_confusion(cm_total, n_classes: int):
    """(per_class_iou, miou, pixel_acc) from an accumulated confusion
    matrix; ``cm_total`` is None when the loader produced no batch."""
    if cm_total is None:
        return np.full(n_classes, np.nan), 0.0, 0.0
    cm = _np(cm_total)
    iou, miou = iou_from_confusion(cm)
    return iou, miou, pixel_accuracy(cm)
