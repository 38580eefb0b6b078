"""The edge-mode rollout in plain float32, teacher-forced on what was
served, and the numbers that judge a served answer.

A request is two seed frames and their layouts; the served answer is 8
frames and 8 layouts. Step t of the reference reads the seeds and the
served frames and layouts before t (HED edges of each frame it reads,
ImageNet normalization, the 10-channel input), runs GridNet, and gives its
logits and frame. A served layout id is judged by how far its logit lies
below the reference's best logit at that pixel (0 where they pick the
same class), a served frame by its largest distance from the reference's
frame. The reference's own argmax is never fed back: on a near tie the
two would part ways and every later step would compare different inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import nets
from .train import Nets


def readings(ref: Nets, i1, i2, s1, s2, frames, layouts,
             cand: Optional[Nets] = None) -> dict:
    """Widest layout gap and frame error of one block of sequences.

    i1, i2 (N, H, W, 3) seed frames in [0, 1]; s1, s2 (N, H, W) int ids;
    frames (N, T, H, W, 3) and layouts (N, T, H, W): what was served,
    which the steps read. With ``cand`` the judged answer of each step is
    ``cand``'s (the control: another precision on the same inputs) instead
    of the served one."""
    n_frames = frames.shape[1]
    f_o = nets.normalize_image(i1.permute(0, 3, 1, 2))
    f_n = nets.normalize_image(i2.permute(0, 3, 1, 2))
    s_o, s_n = s1, s2
    e_o, e_n = ref.edge(i1), ref.edge(i2)
    gap = err = 0.0
    for t in range(n_frames):
        x = nets.model_input(e_o, s_o, f_o, f_n, s_n, e_n)
        seg, frame = _step(ref, x)
        if cand is None:
            ids, got = layouts[:, t].long(), frames[:, t]
        else:
            cseg, got = _step(cand, x)
            ids = cseg.argmax(dim=1)
        best = seg.max(dim=1).values
        picked = seg.gather(1, ids[:, None]).squeeze(1)
        gap = max(gap, float((best - picked).max()))
        err = max(err, float((got - frame).abs().max()))
        if t == n_frames - 1:
            break
        f_o, f_n = f_n, nets.normalize_image(frames[:, t].permute(0, 3, 1, 2))
        s_o, s_n = s_n, layouts[:, t].long()
        e_o, e_n = e_n, ref.edge(frames[:, t].contiguous())
    return dict(layout_gap=gap, frame_err=err)


@torch.no_grad()
def _step(nt: Nets, x):
    """(logits (N, C, H, W), frame (N, H, W, 3) in [0, 1]) of one step."""
    seg, img = nt.gridnet(x)
    frame = nets.denormalize_image(nets.normalize_model_output(img))
    return seg, frame.clamp(0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def request(nt: Nets, i1, i2, s1, s2, n_frames: int):
    """The whole rollout of one request, free running: the work the
    model FLOPs of a request count (``counts.py``). The edges of the last
    frame are never read and are not computed."""
    f_o = nets.normalize_image(i1.permute(0, 3, 1, 2))
    f_n = nets.normalize_image(i2.permute(0, 3, 1, 2))
    s_o, s_n = s1, s2
    e_o, e_n = nt.edge(i1), nt.edge(i2)
    out = []
    for t in range(n_frames):
        seg, frame = _step(nt, nets.model_input(e_o, s_o, f_o, f_n, s_n,
                                                e_n))
        out.append(frame)
        if t == n_frames - 1:
            break
        ids = seg.argmax(dim=1)
        f_o, f_n = f_n, nets.normalize_image(frame.permute(0, 3, 1, 2))
        s_o, s_n = s_n, ids
        e_o, e_n = e_n, nt.edge(frame.contiguous())
    return out
