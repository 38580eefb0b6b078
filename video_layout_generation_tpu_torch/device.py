"""Where the port's entry points run: on the card unless the caller names
the CPU, and on the card only with nets the kernels can take."""

from __future__ import annotations

import torch

from .ops.kernels import plain_active
from .parallel.mesh import in_group, local_rank


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when the process
    has none, instead of running on the CPU. Under a process group a CUDA
    device without an index is the rank's own card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    if dev.type == "cuda" and dev.index is None and in_group():
        dev = torch.device("cuda", local_rank())
    return dev


def require_bf16(device: torch.device, nets) -> None:
    """On a CUDA device the conv kernels take bf16 activations only: raise
    here, by the net's name, for a net built with another ``dtype``, rather
    than inside its first conv. ``nets`` maps names to modules with a
    ``dtype`` attribute; None entries are passed over. Nothing is checked
    under ``ops.kernels.plain()``, where no kernel runs."""
    if device.type != "cuda" or plain_active():
        return
    for name, net in nets.items():
        if net is not None and net.dtype != torch.bfloat16:
            raise ValueError(
                f"{name} was built with dtype={net.dtype}; on a CUDA device "
                f"the conv kernels take bf16 activations only: build it "
                f"with dtype=torch.bfloat16, or run under kernels.plain() "
                f"for the plain versions")
