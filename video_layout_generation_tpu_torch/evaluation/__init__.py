"""Layout quality metrics, prediction export and rollout fidelity of the
port."""

from .export import save_colorized_png, save_npy_stack
from .metrics import (confusion_matrix, iou_from_confusion, pixel_accuracy,
                      summarize_confusion)
from .sequence import (evaluate_layout_rollout, evaluate_trainer_rollout,
                       rollout_fidelity)

__all__ = ["confusion_matrix", "evaluate_layout_rollout",
           "evaluate_trainer_rollout", "iou_from_confusion",
           "pixel_accuracy", "rollout_fidelity", "save_colorized_png",
           "save_npy_stack", "summarize_confusion"]
