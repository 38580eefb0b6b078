"""Validation-epoch accumulation (``Trainer.validate`` of the JAX package's
``train/trainer.py``) as a plain function. The ``Trainer`` class itself is
not ported yet."""

from __future__ import annotations

from typing import Callable, Dict, Iterable

from ..evaluation.metrics import summarize_confusion


def validate(eval_step: Callable, batches: Iterable,
             n_classes: int) -> Dict[str, object]:
    """Run ``eval_step`` (from ``make_eval_step`` with ``n_classes``) over
    ``batches`` and return the size-weighted mean loss, mIoU, pixel
    accuracy and per-class IoU.

    The loss sum and the confusion total stay on the device while the
    batches run; the only fetch is at the end. A loader that produced no
    batch gives a NaN loss, zero scores and NaN per-class IoU."""
    loss_sum = None
    n_total = 0
    cm_total = None
    for batch in batches:
        metrics, _, _ = eval_step(batch)
        bs = next(iter(batch.values())).shape[0]
        n_total += bs
        contrib = metrics["loss"] * bs
        loss_sum = contrib if loss_sum is None else loss_sum + contrib
        cm = metrics["cm"]
        cm_total = cm if cm_total is None else cm_total + cm
    iou, miou, acc = summarize_confusion(cm_total, n_classes)
    if cm_total is None:
        return {"loss": float("nan"), "miou": miou, "pixel_acc": acc,
                "per_class_iou": iou}
    return {"loss": float(loss_sum) / n_total, "miou": miou,
            "pixel_acc": acc, "per_class_iou": iou}
