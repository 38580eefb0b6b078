"""Checkpoint save and restore in the port's own format (the JAX package's
``io/checkpoint.py`` writes orbax, which the port does not import).

A checkpoint is one ``torch.save`` file, ``<dir>/<epoch:03d>/checkpoint.pt``,
with a ``latest`` alias beside it, holding a dict:

- ``params``: the generator's state dict (parameters and buffers, on the
  CPU), under the port's state-dict names (flax's, ``"."``-joined);
- ``opt_state``: ``{"learning_rate", "count", "mu", "nu"}`` of
  ``train/state.py`` (no moments for sgd);
- ``epoch``, ``step`` and ``arch``;
- in GAN mode also ``disc_params`` (the discriminator's parameters),
  ``disc_opt_state`` and, for a BatchNorm discriminator, ``disc_stats``.

Both load modes of the JAX package are kept: ``--ckpt`` warm-starts the
weights through ``merge_params`` (a key- and shape-gated intersection), and
``--resume`` restores everything. ``restore_path`` also reads the flat
``"/"``-joined npz snapshot that ``tools/persist_artifacts.py`` writes (e.g.
``artifacts_store/flagship_096.npz``), as weights only.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .weights import params_from_flax

CKPT_FILE = "checkpoint.pt"
# what a weights-only snapshot holds instead of an optimizer state: a full
# resume from it raises with this text
OPT_STATE_SENTINEL = (
    "weights-only snapshot (tools/persist_artifacts.py): optimizer state "
    "was not persisted; warm-start with --ckpt, not --resume")


def _to_host(tree):
    """Every tensor of a nested dict, copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def merge_params(live: Mapping[str, torch.Tensor],
                 restored: Mapping[str, torch.Tensor]):
    """Key-gated partial warm start: take the restored value for every name
    present in both state dicts with the same shape, keep the live value
    everywhere else (so a GridNet checkpoint seeds a CoordGridNet, or a
    10-channel GridNet an 8-channel one).

    Returns ``(merged, report)``: ``merged`` maps every live name to a
    tensor, and ``report`` holds sorted name lists ``loaded``, ``missing``
    (live only, kept), ``unexpected`` (checkpoint only, dropped) and
    ``shape_mismatch`` (in both, shapes differ, kept; with both shapes)."""
    loaded, mismatched, merged = [], [], {}
    for name, leaf in live.items():
        if name in restored:
            r = restored[name]
            if r.shape == leaf.shape:
                merged[name] = r
                loaded.append(name)
                continue
            mismatched.append(f"{name} (ckpt {tuple(r.shape)} vs "
                              f"live {tuple(leaf.shape)})")
        merged[name] = leaf
    report = {
        "loaded": sorted(loaded),
        "missing": sorted(n for n in live if n not in restored),
        "unexpected": sorted(n for n in restored if n not in live),
        "shape_mismatch": sorted(mismatched),
    }
    return merged, report


@torch.no_grad()
def copy_into(live: Mapping[str, torch.Tensor],
              restored: Mapping[str, torch.Tensor]) -> None:
    """Write ``restored`` into the live tensors of the same names with
    ``copy_``: the modules keep computing with their own tensors, and each
    write bumps the tensor's version, which the kernels' weight-pack cache
    keys on. Names and shapes must match."""
    if set(live) != set(restored):
        raise ValueError(
            f"checkpoint structure mismatch: missing "
            f"{sorted(set(live) - set(restored))[:5]}, unexpected "
            f"{sorted(set(restored) - set(live))[:5]}")
    for name, t in live.items():
        src = restored[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint shape mismatch at {name}: "
                             f"{tuple(src.shape)} vs {tuple(t.shape)}")
        t.copy_(src)


def restore_opt_state(live: dict, restored: dict) -> dict:
    """Restore an optimizer state of ``train/state.py`` into the live one in
    place: the moments by ``copy_``, ``learning_rate`` and ``count`` by
    value. Returns ``live``."""
    if isinstance(restored, str):
        raise ValueError(f"cannot fully resume: {restored}")
    if set(live) != set(restored):
        raise ValueError(f"optimizer state mismatch: live {sorted(live)}, "
                         f"checkpoint {sorted(restored)}")
    for key in ("mu", "nu"):
        if key in live:
            copy_into(live[key], restored[key])
    live["learning_rate"] = float(restored["learning_rate"])
    live["count"] = int(restored["count"])
    return live


def _load_file(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_snapshot(path: str) -> dict:
    """A ``tools/persist_artifacts.py`` npz snapshot as a weights-only
    tree."""
    with np.load(path, allow_pickle=False) as snap:
        flat = {k: snap[k] for k in snap.files}

    def meta(key, cast, default):
        return cast(flat[key]) if key in flat else default

    return {"params": params_from_flax(flat),
            "opt_state": OPT_STATE_SENTINEL,
            "epoch": meta("__epoch__", int, 0),
            "step": meta("__step__", int, 0),
            "arch": meta("__arch__", str, None)}


def _check_arch(tree: dict, arch: Optional[str], where: str) -> dict:
    if arch is not None and tree.get("arch") != arch:
        raise ValueError(f"Architecture mismatch: ckpt {tree.get('arch')} "
                         f"({where}), config {arch}")
    return tree


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag) -> str:
        if isinstance(tag, int):
            tag = f"{tag:03d}"
        return os.path.join(self.directory, str(tag))

    def save(self, epoch: int, params: Mapping, opt_state: Mapping,
             step: int, arch: str, extra: Optional[dict] = None) -> str:
        """Write tag ``epoch`` and point ``latest`` at it; returns its
        directory."""
        tree = {"params": _to_host(params), "opt_state": _to_host(opt_state),
                "epoch": int(epoch), "step": int(step), "arch": arch}
        if extra:
            tree.update(_to_host(extra))
        path = self._path(epoch)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CKPT_FILE + ".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, CKPT_FILE))
        latest = self._path("latest")
        if os.path.islink(latest):
            os.unlink(latest)
        elif os.path.isdir(latest):
            shutil.rmtree(latest)
        try:
            os.symlink(path, latest)
        except OSError:
            shutil.copytree(path, latest)
        return path

    def restore(self, tag, arch: Optional[str] = None) -> dict:
        """Everything of tag ``tag`` (an epoch or ``"latest"``)."""
        return self.restore_path(self._path(tag), arch)

    def restore_weights(self, tag) -> Dict[str, torch.Tensor]:
        """The generator's state dict of tag ``tag`` (a warm start)."""
        return self.restore_path(self._path(tag))["params"]

    @staticmethod
    def restore_path(path: str, arch: Optional[str] = None) -> dict:
        """A checkpoint directory (or its ``checkpoint.pt``), or a flat npz
        snapshot (weights only: its ``opt_state`` is a string that a full
        resume refuses). ``arch`` checks the saved architecture."""
        path = os.path.abspath(path)
        if os.path.isdir(path):
            tree = _load_file(os.path.join(path, CKPT_FILE))
        elif path.endswith(".npz"):
            tree = _load_snapshot(path)
        else:
            tree = _load_file(path)
        return _check_arch(tree, arch, path)
