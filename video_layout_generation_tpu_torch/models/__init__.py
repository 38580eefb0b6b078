"""Model registry of the port (the JAX package's ``get_model_cls``)."""

from .blocks import (CoordConv, CoordDownSamplingBlock, CoordLateralBlock,
                     CoordUpSamplingBlock, DownSamplingBlock, LateralBlock,
                     PReLU, UpSamplingBlock)
from .gridnet import CoordGridNet, GridNet
from .hned import HNED, hned_fused_edge

_REGISTRY = {
    "GridNet": GridNet,
    "CoordGridNet": CoordGridNet,
}


def get_model_cls(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = list(_REGISTRY) + [
    "get_model_cls", "HNED", "hned_fused_edge", "PReLU", "LateralBlock", "DownSamplingBlock",
    "UpSamplingBlock", "CoordConv", "CoordLateralBlock",
    "CoordDownSamplingBlock", "CoordUpSamplingBlock"]
