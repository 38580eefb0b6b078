"""Layout quality metrics and rollout fidelity of the port."""

from .metrics import (confusion_matrix, iou_from_confusion, pixel_accuracy,
                      summarize_confusion)
from .sequence import (evaluate_layout_rollout, evaluate_trainer_rollout,
                       rollout_fidelity)

__all__ = ["confusion_matrix", "evaluate_layout_rollout",
           "evaluate_trainer_rollout", "iou_from_confusion",
           "pixel_accuracy", "rollout_fidelity", "summarize_confusion"]
