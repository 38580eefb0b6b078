"""Host-side helpers of the port (the JAX package's ``utils``)."""

from .meters import AverageMeter, StepTimer
from .profiling import Throughput, annotate, trace
from .trees import param_count, tree_cast

__all__ = ["AverageMeter", "StepTimer", "param_count", "tree_cast",
           "Throughput", "annotate", "trace"]
