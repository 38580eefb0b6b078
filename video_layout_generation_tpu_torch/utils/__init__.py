"""Host-side helpers of the port (the JAX package's ``utils``).

The JAX package's ``Throughput`` (an EMA of items a second) has no
counterpart: nothing read it, and the spans of ``annotate`` time the
port's layers on the profiler's clock."""

from .meters import AverageMeter, StepTimer
from .profiling import annotate, trace
from .trees import param_count, tree_cast

__all__ = ["AverageMeter", "StepTimer", "param_count", "tree_cast",
           "annotate", "trace"]
