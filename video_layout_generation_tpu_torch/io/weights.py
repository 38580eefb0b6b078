"""The weight bridge: a flax parameter tree (GridNet, HNED, VGG19, the
pix2pix generators and discriminators) -> the port's state dict.

The port's modules carry the flax module and parameter names, so a flax
path ``col_1/down_01/Conv_0/kernel`` is the state-dict key
``col_1.down_01.Conv_0.kernel``, and the arrays keep their flax layout
(HWIO kernels, (Co,) biases, scalar PReLU slopes): kernel A and kernel B
read HWIO directly, so nothing is repacked. That holds for the pix2pix nets
too: a ``ConvTranspose`` kernel stays as flax has it, and the port's module
flips it on its way to the library (``models/layers.py``), so parameters,
gradients and optimizer state compare leaf by leaf with the JAX package's.
A BatchNorm's running statistics (flax's ``batch_stats`` collection:
``BatchNorm_0/mean``, ``/var``) are buffers of the port's module under the
same names, so ``{"params": ..., "batch_stats": ...}`` maps onto one state
dict.

``params_from_flax`` takes either form the JAX package produces:

- the nested tree of arrays, with or without its top-level ``"params"``
  and ``"batch_stats"`` keys (``variables``, ``variables["params"]`` or a
  ``batch_stats`` tree alone);
- the ``"/"``-joined flat mapping that ``tools/persist_artifacts.py``
  writes (``artifacts_store/flagship_096.npz``: keys such as
  ``params/col_1/down_01/Conv_0/kernel``, plus ``__epoch__``-style
  metadata, which is skipped);
- the ``"."``-joined flat mapping of the converted pretrained weights
  (``artifacts_store/hned_synth.npz``: ``vgg1_0.kernel``;
  ``artifacts_store/vgg_synth.npz``: ``conv1_1.kernel``), which already has
  the state dict's keys.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _to_tensor(key: str, arr) -> torch.Tensor:
    """f32 tensor of one leaf. A ``key::bfloat16`` entry of a snapshot
    holds the raw bf16 bytes (numpy has no bf16 dtype)."""
    a = np.asarray(arr)
    if key.endswith("::bfloat16"):
        raw = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return raw.view(torch.bfloat16).float()
    if "::" in key:
        raise ValueError(f"unsupported stored dtype in key {key!r}")
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_flax(tree_or_flat: Mapping) -> dict:
    """State dict (``{"lateral_in.Conv_0.kernel": tensor, ...}``, f32 on the
    CPU) for ``load_state_dict`` of a port net from a flax tree or its flat
    form.
    A state dict passes through unchanged."""
    flat = _flatten(tree_or_flat)
    state = {}
    for key, leaf in flat.items():
        if key.startswith("__"):
            continue
        path = key.split("::", 1)[0].split("/")
        if path[0] in ("params", "batch_stats"):
            path = path[1:]
        state[".".join(path)] = _to_tensor(key, leaf)
    return state


_HNED_CONVS = (
    [f"vgg{b+1}_{j}" for b, n in enumerate((2, 2, 3, 3, 3))
     for j in range(n)]
    + [f"score{i}" for i in range(1, 6)] + ["combine"])


def load_hned_params(path: str) -> dict:
    """State dict of the port's HNED from a converted ``.npz`` of HWIO
    kernels and biases keyed ``vgg1_0.kernel``, ``score1.bias``, ..."""
    raw = np.load(path)
    return params_from_flax({f"{n}.{leaf}": raw[f"{n}.{leaf}"]
                             for n in _HNED_CONVS
                             for leaf in ("kernel", "bias")})
