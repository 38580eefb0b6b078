"""The validation step (the forward half of the JAX package's
``train/steps.py``).

One call covers the whole step: decode of the compact batch, frozen HNED
edge extraction, normalization, input assembly, the model forward, the
3-term loss ``w_l1*L1 + w_style*(VGG+SSIM+Grad) + w_seg*CE`` and the
confusion matrix. On the card every 3x3 conv of GridNet, HNED and VGG19 is
a launch of kernel A or B and the SSIM term one launch of the fused SSIM
kernel. The train step (backward of the conv kernels, optimizer, flip) is
not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..device import require_bf16, resolve_device
from ..evaluation.metrics import confusion_matrix
from ..losses.ce import cross_entropy_loss
from ..losses.pixel import l1_loss
from ..models.hned import hned_fused_edge
from .assemble import (assemble_model_input, normalize_image,
                       normalize_model_output)


def decode_batch(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side decode of compact-transfer batches.

    A batch may come as one uint8 array ``packed6`` (N, H, W, 12): frames 1-3
    in channels 0-8, layouts 1-3 in channels 9-11. uint8 frames become f32 in
    [0, 1], layout ids f32 model channels (``seg1``, ``seg2``, (N, H, W, 1))
    and int64 targets (``seg3``, (N, H, W)). f32 batches pass through."""
    if "packed6" in batch:
        p = batch["packed6"]
        batch = {"img1": p[..., 0:3], "img2": p[..., 3:6],
                 "img3": p[..., 6:9], "seg1": p[..., 9:10],
                 "seg2": p[..., 10:11], "seg3": p[..., 11]}
    out = dict(batch)
    for k in ("img1", "img2", "img3"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() * (1.0 / 255.0)
    for k in ("seg1", "seg2"):
        if k in out and out[k].dtype != torch.float32:
            out[k] = out[k].float()
    if "seg3" in out and out["seg3"].dtype != torch.int64:
        out["seg3"] = out["seg3"].long()
    return out


def prepare_inputs(hned: Optional[Callable], batch: Mapping[str, torch.Tensor],
                   plain: bool = False):
    """Edges + normalization + channel assembly -> (x, frame3 normalized).
    ``hned`` is a port HNED or None (8-channel input)."""
    f1, f2, f3 = batch["img1"], batch["img2"], batch["img3"]
    s1, s2 = batch["seg1"], batch["seg2"]
    if hned is not None:
        e1 = hned_fused_edge(hned, f1, plain)
        e2 = hned_fused_edge(hned, f2, plain)
    else:
        e1 = e2 = None
    f1n, f2n, f3n = (normalize_image(f) for f in (f1, f2, f3))
    return assemble_model_input(s1, f1n, f2n, s2, e1, e2), f3n


def make_loss_fn(model: Callable, combined_loss, w_l1: float = 40.0,
                 w_style: float = 20.0, w_seg: float = 10.0):
    """Build ``loss_fn(x, f3n, s3, plain=False) -> (loss, (metrics,
    seg_logits, img_n))``."""

    def loss_fn(x, f3n, s3, plain: bool = False):
        seg_logits, img = model(x, plain=plain)
        img_n = normalize_model_output(img)
        loss_l1 = l1_loss(img_n, f3n) * w_l1
        loss_style = combined_loss(img_n, f3n, plain=plain) * w_style
        loss_seg = cross_entropy_loss(seg_logits, s3) * w_seg
        total = loss_l1 + loss_style + loss_seg
        metrics = {"loss": total, "loss_l1": loss_l1,
                   "loss_style": loss_style, "loss_seg": loss_seg}
        return total, (metrics, seg_logits, img_n)

    return loss_fn


def make_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the train step needs the backward kernels of the conv kernels and "
        "the optimizers, which the port does not have yet")


def _to_device(batch: Mapping, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_eval_step(model: torch.nn.Module, hned: Optional[torch.nn.Module],
                   combined_loss, w_l1: float = 40.0, w_style: float = 20.0,
                   w_seg: float = 10.0, n_classes: Optional[int] = None,
                   plain: bool = False, device="cuda"):
    """Returns ``eval_step(batch) -> (metrics, seg_pred_ids, img_pred_norm)``.

    The three nets (``model``, ``hned`` or None, the VGG trunk of
    ``combined_loss``) are moved to ``device`` and set to eval mode here; a
    CUDA device raises when the process has none, or when a net was not
    built for bf16 and ``plain`` is off. ``batch`` maps names to numpy arrays
    or tensors (``packed6``, or ``img1..3`` / ``seg1..3``) and is moved there
    too. With
    ``n_classes`` set, ``metrics["cm"]`` carries the (C, C) confusion matrix
    [target, pred] of the batch. Everything returned stays on the device.
    ``plain=True`` runs every kernel's plain PyTorch version (the on-card
    reference)."""
    dev = resolve_device(device)
    nets = {"GridNet": model, "HNED": hned,
            "the VGG19 trunk of CombinedLoss": combined_loss.vgg_model}
    if not plain:
        require_bf16(dev, nets)
    for net in nets.values():
        if net is not None:
            net.to(dev).eval()
    loss_fn = make_loss_fn(model, combined_loss, w_l1, w_style, w_seg)

    @torch.no_grad()
    def eval_step(batch):
        batch = decode_batch(_to_device(batch, dev))
        x, f3n = prepare_inputs(hned, batch, plain)
        _, (metrics, seg_logits, img_n) = loss_fn(x, f3n, batch["seg3"],
                                                  plain)
        seg_ids = seg_logits.argmax(dim=-1)
        if n_classes is not None:
            metrics = dict(metrics, cm=confusion_matrix(
                seg_ids, batch["seg3"], n_classes))
        return metrics, seg_ids, img_n

    return eval_step
