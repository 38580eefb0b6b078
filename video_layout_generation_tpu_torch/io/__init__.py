"""Checkpoints, logging, TensorBoard events, the weight bridge (a flax
parameter tree -> the port's state dict, ``io/weights.py``), the torch
checkpoint reader and the native image loader."""

from .checkpoint import CheckpointManager
from .logging import get_logger
from .tb import SummaryWriter

__all__ = ["CheckpointManager", "get_logger", "SummaryWriter"]
