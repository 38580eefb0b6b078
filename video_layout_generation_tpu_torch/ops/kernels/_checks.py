"""Argument checks, pointer plumbing and the plain mode shared by the
kernel wrappers."""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

# True while ``plain()`` is entered. One value for the process, not one a
# thread: autograd runs a CUDA backward, and a checkpoint's recomputation
# inside it, on a thread of its own, which must see the forward's mode.
PLAIN = False


@contextlib.contextmanager
def plain(on: bool = True):
    """While entered (with ``on``), every kernel wrapper returns its
    ``*_plain`` version under ordinary autograd, on the card too: the
    on-card reference. ``plain(False)`` inside it runs the kernels again.
    Nests, and restores the mode it found on exit, exceptions included.

    A wrapper reads the mode in its forward, and a kernel's autograd
    Function keeps its forward's route in the backward; a recomputation in
    the backward (GridNet's ``remat``) reads it again. So enter the mode
    around the backward pass as well as the forward pass."""
    global PLAIN
    before, PLAIN = PLAIN, bool(on)
    try:
        yield
    finally:
        PLAIN = before


def plain_active() -> bool:
    """Whether ``plain()`` is entered."""
    return PLAIN


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape: tuple,
               name: str, device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned CUDA tensor of
    ``dtype`` and ``shape`` (on ``device`` where given) whose images (the
    slices of a 4-D tensor's first axis) the kernels can index in 32 bits.
    It runs several times per launch, so a tensor that passes takes one
    condition; what is wrong is worked out only on the way to the error."""
    if (t.is_cuda and t.dtype is dtype and t.shape == shape
            and t.is_contiguous() and not t.data_ptr() & 15
            and t.numel() < 2 ** 31
            and (device is None or t.device == device)):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if t.dim() == 4 and t.numel() >= 2 ** 31 * max(t.shape[0], 1):
        raise ValueError(f"{name}: one image must hold fewer than 2^31 "
                         f"values, got {tuple(t.shape)}")


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle (read
    without building a ``torch.cuda.Stream`` object: this runs once per
    launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the persistent kernels size
    their grids by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
