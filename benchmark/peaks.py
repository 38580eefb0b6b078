"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives. NVIDIA's data sheet of the H100
SXM part, dense rates without sparsity, at its 700 W limit. A share of a
peak is stated against these, with the card's power limit beside it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Peaks:
    bf16_flops: float       # FLOP/s, tensor cores
    f32_flops: float        # FLOP/s outside the tensor cores
    bytes_per_s: float      # HBM


H100_SXM = Peaks(bf16_flops=989e12, f32_flops=67e12, bytes_per_s=3.35e12)

_BY_NAME = (("H100 80GB HBM3", H100_SXM), ("H100 SXM", H100_SXM))


def lookup(device_name: str) -> Optional[Peaks]:
    """The peaks of a card, or None for a card not in the table."""
    for key, peaks in _BY_NAME:
        if key in device_name:
            return peaks
    return None
