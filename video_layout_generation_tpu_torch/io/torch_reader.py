"""Reader of torch-serialized checkpoints, and the mapping of the
reference's pretrained state dicts onto the port's modules (the JAX
package's ``io/torch_reader.py`` and ``tools/convert_torch_weights.py``).

The reference's pretrained artifacts are torch ``.pth`` files: torchvision's
VGG19 (reference src/loss.py:33) and an external HED checkpoint (reference
src/trainer.py:97-99). The JAX package reads them without torch, with a
pickle reader of its own; the port has torch, so both formats of
``torch.save`` (the zip container and the legacy stream) are read with
``torch.load(path, map_location="cpu", weights_only=True)``, whose
unpickler admits tensors and plain containers only and refuses any other
object, so a hostile pickle cannot run code through this reader.

- ``read_torch_checkpoint(path)``: the saved object with every tensor as a
  contiguous numpy array (bf16, which numpy lacks, as its exact f32 value);
- ``read_torch_state_dict(path, key=None)``: a flat name -> array dict,
  ``key`` selecting a wrapped one (``{"generator": sd}``);
- ``convert_hned(sd)`` / ``convert_vgg19(sd)``: an upstream HED or
  torchvision VGG19 state dict -> the state dict of the port's ``HNED``
  (``models/hned.py``: the keys ``io/weights.py:load_hned_params`` reads)
  or ``VGG19Features`` (``losses/vgg.py``), kernels turned from OIHW into
  HWIO. VGG19 needs its state dict: nothing is downloaded.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .weights import params_from_flax


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy(order="C")
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def read_torch_checkpoint(path: str) -> Any:
    """Read a ``torch.save`` artifact (zip or legacy format) into numpy
    trees."""
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def read_torch_state_dict(path: str, key: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    """Read a checkpoint and return a flat name -> numpy state dict.

    ``key`` selects a sub-dict for checkpoints that wrap the state dict
    (e.g. ``{"generator": sd}``)."""
    obj = read_torch_checkpoint(path)
    if key is not None:
        obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint {path} did not contain a state dict")
    return {str(k): np.asarray(v) for k, v in obj.items()
            if isinstance(v, np.ndarray)}


def _to_hwio(w) -> np.ndarray:
    # torch conv weight OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                             (2, 3, 1, 0)))


def _convert(state_dict: Mapping, names: Mapping[str, str]) -> dict:
    out = {}
    for tname, name in names.items():
        out[f"{name}.kernel"] = _to_hwio(state_dict[f"{tname}.weight"])
        out[f"{name}.bias"] = np.asarray(state_dict[f"{tname}.bias"],
                                         np.float32)
    return params_from_flax(out)


# torchvision ``vgg19.features`` conv indices up to relu4_4 -> conv{b}_{j}
_VGG19_NAMES = dict(zip(
    (f"features.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25)),
    (f"conv{b+1}_{j+1}" for b, n in enumerate((2, 2, 4, 4))
     for j in range(n))))

# the HED implementation's module names -> the port's HNED names; the
# convs sit at even indices of each stage's Sequential, shifted by one by
# the pool that opens every stage but the first
_HNED_NAMES = {
    f"module{tname}.{(0 if stage == 0 else 1) + 2 * j}": f"vgg{stage+1}_{j}"
    for stage, (tname, n) in enumerate((("VggOne", 2), ("VggTwo", 2),
                                        ("VggThr", 3), ("VggFou", 3),
                                        ("VggFiv", 3)))
    for j in range(n)}
_HNED_NAMES.update({f"moduleScore{t}": f"score{i+1}" for i, t in
                    enumerate(("One", "Two", "Thr", "Fou", "Fiv"))})
_HNED_NAMES["moduleCombine.0"] = "combine"


def convert_vgg19(state_dict: Optional[Mapping]) -> dict:
    """The state dict of ``losses/vgg.py:VGG19Features`` from torchvision's
    ``vgg19`` state dict (``features.<i>.weight`` / ``.bias``)."""
    if state_dict is None:
        raise ValueError("convert_vgg19 needs torchvision's vgg19 state "
                         "dict (read it with read_torch_state_dict); "
                         "nothing is downloaded")
    return _convert(state_dict, _VGG19_NAMES)


def convert_hned(state_dict: Mapping) -> dict:
    """The state dict of ``models/hned.py:HNED`` from the HED
    implementation's (``moduleVggOne.0.weight``, ``moduleScoreOne.bias``,
    ``moduleCombine.0.weight``, ...)."""
    return _convert(state_dict, _HNED_NAMES)
