"""Autoregressive rollout (the JAX package's ``train/rollout.py`` and, for
the no-edge contract, ``models/fast_gridnet.py:make_packed_rollout_fn``).

From two seed frames and layouts, each step assembles the model input from
the last two (frame, layout) pairs, runs GridNet, maps the image head
through ``normalize_model_output`` in f32, and feeds back the argmax layout
(first index on ties).

- ``use_edges=False``: the 8-channel input ``[seg_old, img_old, img_new,
  seg_new]``; the carry is kept in the model's dtype.
- ``use_edges=True``: the 10-channel input ``[edge_old, seg_old, img_old,
  img_new, seg_new, edge_new]`` of the trained model. The fused HNED edge
  map of every fed-back frame is computed once and carried, so HNED runs
  once per generated frame (plus twice for the seeds); the carry stays f32
  as in the JAX rollout, and the model rounds its input itself.
  ``edge_scale=k`` runs HNED on a 1/k bilinear downsample of the frame and
  resizes the edge map back (about k^2 less HNED work, an opt-in
  approximation).

The frame loop is a Python loop: PyTorch runs eagerly, and every 3x3 conv
inside it is one launch of kernel A or kernel B. Under a profiler each
generated frame records a ``rollout.frame`` span holding ``rollout.step``
(GridNet) and, with edges, ``rollout.edge`` (HNED, also recorded for the
two seed frames). Serving on a card replays the loop's stages from CUDA
graphs instead (``serving.py``); the trainer runs it eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models.hned import hned_fused_edge
from ..ops.resize import resize_bilinear
from ..utils.profiling import annotate
from .assemble import (assemble_model_input, denormalize_image,
                       normalize_model_output)


def make_rollout_fn(model: Callable, hned: Optional[Callable] = None,
                    n_frames: int = 8, use_edges: bool = False,
                    upsample: str = "bilinear", edge_scale: int = 1
                    ) -> Callable:
    """Build ``rollout(img1, img2, seg1, seg2) -> (imgs, segs)``.

    ``model`` is a port GridNet (10 input channels with ``use_edges``, else
    8) and ``hned`` a port HNED.

    img1/img2: (N, H, W, 3) ImageNet-normalized seed frames, older first;
    seg1/seg2: (N, H, W, 1) float class ids. Returns imgs (N, T, H, W, 3)
    normalized and segs (N, T, H, W, 1) float ids, both f32.

    The rollout's stages are its attributes: ``start(img1, img2, seg1,
    seg2) -> carry``, ``frame(carry) -> (carry, frame, layout)``, called
    ``n_frames`` times, and ``finish(frames, layouts)``. ``rollout`` is
    ``finish`` of the frames, each in its ``rollout.frame`` span; serving
    captures ``start`` and each ``frame`` as CUDA graphs
    (``serving.py``).
    """
    if use_edges and hned is None:
        raise ValueError("use_edges=True requires an HNED model")
    if edge_scale < 1:
        raise ValueError(f"edge_scale must be >= 1, got {edge_scale}")
    if upsample not in ("bilinear", "nearest"):
        raise ValueError(f"rollout upsample must be 'bilinear' or "
                         f"'nearest', got {upsample!r}")

    def edge(f: torch.Tensor) -> torch.Tensor:
        with annotate("rollout.edge"):
            img = denormalize_image(f)
            if edge_scale == 1:
                return hned_fused_edge(hned, img)
            h, w = img.shape[1], img.shape[2]
            # HNED's 4 stride-2 pools need >= 16 px on each side
            sh, sw = h // edge_scale, w // edge_scale
            if sh < 16 or sw < 16:
                raise ValueError(
                    f"edge_scale={edge_scale} shrinks {h}x{w} frames to "
                    f"{sh}x{sw}; HNED needs at least 16x16 inputs")
            small = resize_bilinear(img, (sh, sw), align_corners=False)
            return resize_bilinear(hned_fused_edge(hned, small),
                                   (h, w), align_corners=False)

    def step(x):
        with annotate("rollout.step"):
            seg_logits, img = model(x, upsample=upsample)
            img_n = normalize_model_output(img.float())
            seg_next = seg_logits.float().argmax(dim=-1, keepdim=True)
            return img_n, seg_next

    def start(img1, img2, seg1, seg2) -> tuple:
        """The carry of the first frame: the seeds (and their edges)."""
        if use_edges:
            f_old, f_new = img1.float(), img2.float()
            return (f_old, f_new, seg1.float(), seg2.float(), edge(f_old),
                    edge(f_new))
        dt = model.dtype or img1.dtype
        return tuple(t.to(dt) for t in (img1, img2, seg1, seg2))

    def frame(carry: tuple) -> tuple:
        """One generated frame: (the next carry, its frame, its layout)."""
        if use_edges:
            f_old, f_new, s_old, s_new, e_old, e_new = carry
            img_n, seg_next = step(assemble_model_input(
                s_old, f_old, f_new, s_new, e_old, e_new))
            seg_next = seg_next.float()
            return ((f_new, img_n, s_new, seg_next, e_new, edge(img_n)),
                    img_n, seg_next)
        f_old, f_new, s_old, s_new = carry
        img_n, seg_next = step(assemble_model_input(s_old, f_old, f_new,
                                                    s_new))
        img_n, seg_next = img_n.to(f_new.dtype), seg_next.to(f_new.dtype)
        return (f_new, img_n, s_new, seg_next), img_n, seg_next

    def finish(imgs, segs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frames and layouts stacked along T, in f32."""
        return (torch.stack(imgs, dim=1).float(),
                torch.stack(segs, dim=1).float())

    def rollout(img1, img2, seg1, seg2
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        carry = start(img1, img2, seg1, seg2)
        imgs, segs = [], []
        for _ in range(n_frames):
            with annotate("rollout.frame"):
                carry, img_n, seg_next = frame(carry)
            imgs.append(img_n)
            segs.append(seg_next)
        return finish(imgs, segs)

    rollout.start, rollout.frame, rollout.finish = start, frame, finish
    rollout.n_frames = n_frames
    return rollout
