"""Parameter-tree helpers (the JAX package's ``utils/trees.py``) over a
module's parameters or a state dict, nested dicts of tensors included."""

from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

Tree = Union[nn.Module, Mapping, torch.Tensor]


def _tree(tree: Tree):
    return (dict(tree.named_parameters()) if isinstance(tree, nn.Module)
            else tree)


def param_count(tree: Tree) -> int:
    """Elements of every tensor of a state dict (buffers included, as the
    JAX package counts a ``batch_stats`` collection it is handed), or of a
    module's parameters."""
    tree = _tree(tree)
    if isinstance(tree, Mapping):
        return sum(param_count(v) for v in tree.values())
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


def tree_cast(tree: Tree, dtype: torch.dtype):
    """The tree with every floating tensor cast to ``dtype`` and every other
    leaf as it is; a module gives its parameters, detached."""
    tree = _tree(tree)
    if isinstance(tree, Mapping):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.detach().to(dtype)
    return tree
