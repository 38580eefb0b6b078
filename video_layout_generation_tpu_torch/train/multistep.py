"""Multi-step (backprop-through-rollout) training (the JAX package's
``train/multistep.py``).

The predictor is trained on K consecutive autoregressive steps: it is fed
its own predictions back as the rollout feeds them (``train/rollout.py``),
and the 3-term loss of ``train/steps.py`` is averaged over the K predicted
frames. With K=1 the objective, and every number of the step, is that of
``make_train_step``.

Feedback: the predicted frame is fed back differentiably, so the inputs of
steps 2..K carry gradient through ``assemble_model_input`` into the model's
first layer (on the card the data gradient of kernel A's Function, the
library's VJP); the layout feedback is the argmax, detached; the edge maps
of fed-back frames are computed by the frozen HNED under ``no_grad``, as
the JAX package's ``stop_gradient`` does, outside the recomputed region.

``remat_steps=True`` (the JAX package's ``jax.checkpoint`` of each scan
step) runs each step's forward and losses through
``torch.utils.checkpoint`` (non-reentrant): the live activations stay one
step deep. The recomputation stops at the last tensor the backward saved,
the cross entropy's, so the step's GridNet and both VGG19 forwards run
again: a step launches kernel A 31 + 24 and kernel B 15 times more on the
card.

Randomness: the whole-batch flip's coin is a host draw (``flip_coin``); the
feedback noise and the layout corruption are drawn on the device from
``noise_generator`` (``draw_rollout_noise``) before the steps run, so that
no recomputed region draws anything. The loss function takes the coin and
the noise as arguments: tests hand it the JAX package's draws.

Data contract: the stacked window batch {"imgs": (N,T,H,W,3), "segs":
(N,T,H,W)} with T = K+2 (2 seed frames + K targets), or its packed uint8
form ``packedseq`` (N,T,H,W,4) (``data/pipeline.py:pack_triplet_batch``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..losses.ce import cross_entropy_loss
from ..losses.pixel import l1_loss
from ..models.hned import hned_fused_edge
from .assemble import (assemble_model_input, const_like, denormalize_image,
                       normalize_image, normalize_model_output)
from ..parallel.collectives import draw_rows
from ..utils.profiling import annotate
from .steps import (_maybe_flip, _to_device, apply_shared, flip_coin,
                    place_nets)

def decode_window_batch(batch: Mapping[str, torch.Tensor]):
    """Device-side decode of the stacked window batch -> (imgs f32 in [0,1]
    (N,T,H,W,3), segs int64 (N,T,H,W)). Takes the packed uint8 upload
    (``packedseq``), uint8 pairs or float pairs."""
    if "packedseq" in batch:
        p = batch["packedseq"]
        imgs, segs = p[..., 0:3], p[..., 3]
    else:
        imgs, segs = batch["imgs"], batch["segs"]
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() * (1.0 / 255.0)
    return imgs, segs.long()


def window_to_triplet_batch(batch: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The first triplet of a window batch in the float triplet contract,
    for the consumers of triplets (the eval step, TensorBoard grids)."""
    imgs, segs = decode_window_batch(batch)
    return {"img1": imgs[:, 0], "img2": imgs[:, 1], "img3": imgs[:, 2],
            "seg1": segs[:, 0].float()[..., None],
            "seg2": segs[:, 1].float()[..., None], "seg3": segs[:, 2]}


def is_window_batch(batch: Mapping) -> bool:
    return "packedseq" in batch or "imgs" in batch


def _f32_weights(vals) -> torch.Tensor:
    """Step weights as the JAX package makes them: an f32 vector divided by
    its f32 mean (mean 1)."""
    w = torch.tensor(vals, dtype=torch.float32)
    return w / w.mean()


def make_multistep_loss_fn(model, hned, combined_loss, k: int,
                           w_l1: float = 40.0, w_style: float = 20.0,
                           w_seg: float = 10.0, remat_steps: bool = True,
                           discount: float = 1.0,
                           feedback_noise: float = 0.0,
                           layout_noise: float = 0.0,
                           image_weight: float = 1.0,
                           image_discount: float = 1.0):
    """Build ``loss_fn(imgs, segs, coin, noise=None) -> (loss, metrics)``
    over K autoregressive steps. imgs (N,K+2,H,W,3) in [0,1];
    segs (N,K+2,H,W) int; coin a bool (the whole-batch flip); noise the
    dict of ``draw_rollout_noise`` (``feedback`` (K-1,N,H,W,3) unit
    normals; ``layout_mask`` (K-1,N,H,W,1) bool and ``layout_cls``
    (K-1,N,H,W,1) f32 class ids), entry i perturbing the feedback of step
    i+1. ``hned`` None means no edge channels.

    The levers are the JAX package's: ``discount`` < 1 up-weights late
    steps (step i weighs discount**(k-1-i), mean 1); ``feedback_noise``
    adds sigma * noise to the fed-back frame (normalized space);
    ``layout_noise`` replaces each fed-back layout pixel that its mask
    marks with a random class; ``image_weight`` scales the image terms (l1
    and style) against the seg term, the total renormalized by
    (w_l1+w_style+w_seg)/(m*(w_l1+w_style)+w_seg); ``image_discount`` < 1
    up-weights early steps' image terms (weight image_discount**i, mean 1).
    At the defaults the objective is the plain mean over the steps.

    Flip order as the reference's: the seed edges come from the unflipped
    frames, then inputs, targets and edge maps flip together."""
    if k < 1:
        raise ValueError(f"multistep k must be >= 1, got {k}")
    use_edges = hned is not None
    step_w = _f32_weights([discount ** (k - 1 - i) for i in range(k)])
    if image_weight == 1.0 and image_discount == 1.0:
        w_mat = step_w[:, None].expand(k, 3)
        renorm = None
    else:
        img_w = _f32_weights([image_discount ** i for i in range(k)])
        img_w = step_w * img_w * image_weight
        w_mat = torch.stack([img_w, img_w, step_w], dim=1)
        renorm = (w_l1 + w_style + w_seg) / (
            image_weight * (w_l1 + w_style) + w_seg)
    # a cached device copy (assemble.const_like): no upload in the step
    w_vals = tuple(tuple(float(v) for v in row) for row in w_mat)
    remat = remat_steps and k > 1

    def step_terms(x, tf, ts):
        seg_logits, img = model(x)
        img_n = normalize_model_output(img)
        terms = torch.stack([
            l1_loss(img_n, tf) * w_l1,
            combined_loss(img_n, tf) * w_style,
            cross_entropy_loss(seg_logits, ts) * w_seg])
        return terms, seg_logits, img_n

    def edge(frame):
        with torch.no_grad():
            return hned_fused_edge(hned, frame.contiguous())

    def loss_fn(imgs, segs, coin, noise: Optional[dict] = None):
        if imgs.shape[1] != k + 2:
            raise ValueError(f"multistep k={k} needs {k + 2}-frame windows, "
                             f"got {imgs.shape[1]}")
        with torch.no_grad():
            seeds = [normalize_image(imgs[:, 0]), normalize_image(imgs[:, 1]),
                     segs[:, 0].float()[..., None],
                     segs[:, 1].float()[..., None]]
            if use_edges:
                seeds += [edge(imgs[:, i]) for i in (0, 1)]
            tgt_f = [normalize_image(imgs[:, 2 + i]) for i in range(k)]
            tgt_s = [segs[:, 2 + i].contiguous() for i in range(k)]
            if coin:
                seeds = list(_maybe_flip(True, *seeds))
                tgt_f = list(_maybe_flip(True, *tgt_f))
                tgt_s = list(_maybe_flip(True, *tgt_s))
        carry = seeds
        per_step = []
        for i in range(k):
            f_o, f_n, s_o, s_n = carry[:4]
            edges = carry[4:]
            x = assemble_model_input(s_o, f_o, f_n, s_n, *edges)
            if remat:
                terms, seg_logits, img_n = checkpoint(
                    step_terms, x, tgt_f[i], tgt_s[i],
                    use_reentrant=False, preserve_rng_state=False)
            else:
                terms, seg_logits, img_n = step_terms(x, tgt_f[i], tgt_s[i])
            per_step.append(terms)
            if i == k - 1:
                break                   # the last feedback is never read
            with torch.no_grad():
                s_next = seg_logits.argmax(dim=-1)[..., None].float()
                if layout_noise > 0.0:
                    s_next = torch.where(noise["layout_mask"][i],
                                         noise["layout_cls"][i], s_next)
            img_fb = img_n
            if feedback_noise > 0.0:
                img_fb = img_n + feedback_noise * noise["feedback"][i]
            carry = [f_n, img_fb, s_n, s_next]
            if use_edges:
                carry += [edges[1], edge(denormalize_image(img_fb.detach()))]
        per_step = torch.stack(per_step)                     # (K, 3)
        terms = (const_like(w_vals, per_step) * per_step).mean(dim=0)
        if renorm is not None:
            terms = renorm * terms
        total = terms[0] + terms[1] + terms[2]
        metrics = {"loss": total, "loss_l1": terms[0],
                   "loss_style": terms[1], "loss_seg": terms[2],
                   "loss_per_step": per_step.sum(dim=1)}
        return total, metrics

    return loss_fn


def draw_rollout_noise(k: int, n: int, hw, seg_classes: int,
                       feedback_noise: float, layout_noise: float,
                       generator: Optional[torch.Generator], device
                       ) -> Optional[dict]:
    """The perturbations of the K-1 feedbacks a K-step loss reads, drawn
    on ``device`` from ``generator``: ``feedback`` (K-1,N,H,W,3) unit
    normals where ``feedback_noise`` > 0; ``layout_mask`` (K-1,N,H,W,1),
    true with probability ``layout_noise``, and ``layout_cls`` (same
    shape, f32 class ids uniform in [0, seg_classes)) where
    ``layout_noise`` > 0. None when both levers are off. Each is this
    rank's n rows (axis 1) of the global batch's draw."""
    if feedback_noise <= 0.0 and layout_noise <= 0.0:
        return None
    hw = tuple(hw)
    kw = dict(generator=generator, device=device)

    def shape(m, c):
        return (k - 1, m) + hw + (c,)

    out = {}
    if feedback_noise > 0.0:
        out["feedback"] = draw_rows(lambda m: torch.randn(shape(m, 3), **kw),
                                    n, dim=1)
    if layout_noise > 0.0:
        out["layout_mask"] = draw_rows(
            lambda m: torch.rand(shape(m, 1), **kw), n, dim=1) < layout_noise
        out["layout_cls"] = draw_rows(
            lambda m: torch.randint(0, seg_classes, shape(m, 1), **kw), n,
            dim=1).float()
    return out


def make_multistep_train_step(model: torch.nn.Module, hned, combined_loss,
                              k: int, w_l1: float = 40.0,
                              w_style: float = 20.0, w_seg: float = 10.0,
                              flip_mode: str = "batch",
                              remat_steps: bool = True,
                              discount: float = 1.0,
                              feedback_noise: float = 0.0,
                              layout_noise: float = 0.0,
                              image_weight: float = 1.0,
                              image_discount: float = 1.0, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              noise_generator: Optional[torch.Generator]
                              = None, seg_classes: int = 20):
    """Returns ``train_step(state, batch) -> (state, metrics)`` over the
    window contract, as ``make_train_step`` does over triplets (the nets
    move to ``device``; the state updates in place; ``metrics`` holds the
    detached terms and ``loss_per_step`` (K,) on the device).

    ``flip_mode`` is ``"batch"`` (one coin over the whole window, drawn on
    the host from ``generator``) or ``"none"``. ``noise_generator`` (on
    ``device``) draws the feedback noise and the layout corruption;
    ``seg_classes`` is the model's number of layout classes (GridNet's
    ``seg_out``), the range of the random classes."""
    if flip_mode not in ("batch", "none"):
        raise ValueError(f"multistep flip_mode must be 'batch' or 'none', "
                         f"got {flip_mode!r}")
    dev = place_nets(model, hned, combined_loss, device)
    loss_fn = make_multistep_loss_fn(
        model, hned, combined_loss, k, w_l1, w_style, w_seg, remat_steps,
        discount, feedback_noise, layout_noise, image_weight, image_discount)

    def train_step(state, batch):
        with annotate("step.inputs"):
            with torch.no_grad():
                imgs, segs = decode_window_batch(_to_device(batch, dev))
            coin = (flip_coin("batch", imgs.shape[0], generator, dev)
                    if flip_mode == "batch" else False)
            noise = draw_rollout_noise(k, imgs.shape[0], imgs.shape[2:4],
                                       seg_classes, feedback_noise,
                                       layout_noise, noise_generator, dev)
        with annotate("step.forward"), torch.enable_grad():
            total, metrics = loss_fn(imgs, segs, coin, noise)
        return apply_shared(state, total, metrics)

    return train_step
