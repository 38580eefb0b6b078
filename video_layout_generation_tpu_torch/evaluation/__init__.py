"""Layout quality metrics of the port."""

from .metrics import (confusion_matrix, iou_from_confusion, pixel_accuracy,
                      summarize_confusion)

__all__ = ["confusion_matrix", "iou_from_confusion", "pixel_accuracy",
           "summarize_confusion"]
