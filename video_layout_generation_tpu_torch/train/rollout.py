"""Autoregressive no-edge rollout (the JAX package's ``train/rollout.py``
with ``use_edges=False`` and ``models/fast_gridnet.py:
make_packed_rollout_fn``).

From two seed frames and layouts, each step assembles
``[seg_old, img_old, img_new, seg_new]`` (8 channels), runs GridNet, maps
the image head through ``normalize_model_output`` in f32 and casts it to
the carry dtype, and feeds back the argmax layout (first index on ties).
The frame loop is a Python loop: PyTorch runs eagerly, and every conv
inside it is one launch of kernel A or kernel B.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .assemble import assemble_model_input, normalize_model_output


def make_rollout_fn(model: Callable, n_frames: int = 8,
                    use_edges: bool = False, upsample: str = "bilinear",
                    plain: bool = False) -> Callable:
    """Build ``rollout(img1, img2, seg1, seg2) -> (imgs, segs)``.

    ``model`` is a port GridNet; its ``dtype`` (or the seeds' dtype) is the
    carry dtype. ``plain=True`` runs the kernels' plain PyTorch versions
    (the on-card reference).

    img1/img2: (N, H, W, 3) ImageNet-normalized seed frames, older first;
    seg1/seg2: (N, H, W, 1) float class ids. Returns imgs (N, T, H, W, 3)
    normalized and segs (N, T, H, W, 1) float ids, both f32.
    """
    if use_edges:
        raise NotImplementedError(
            "edge-mode rollout needs the HNED edge net, which the port does "
            "not have yet")
    if upsample not in ("bilinear", "nearest"):
        raise ValueError(f"rollout upsample must be 'bilinear' or "
                         f"'nearest', got {upsample!r}")

    def rollout(img1, img2, seg1, seg2
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = model.dtype or img1.dtype
        f_old, f_new = img1.to(dt), img2.to(dt)
        s_old, s_new = seg1.to(dt), seg2.to(dt)
        imgs, segs = [], []
        for _ in range(n_frames):
            x = assemble_model_input(s_old, f_old, f_new, s_new)
            seg_logits, img = model(x, plain=plain, upsample=upsample)
            img_n = normalize_model_output(img.float()).to(dt)
            seg_next = seg_logits.float().argmax(dim=-1,
                                                 keepdim=True).to(dt)
            imgs.append(img_n)
            segs.append(seg_next)
            f_old, f_new, s_old, s_new = f_new, img_n, s_new, seg_next
        return (torch.stack(imgs, dim=1).float(),
                torch.stack(segs, dim=1).float())

    return rollout
