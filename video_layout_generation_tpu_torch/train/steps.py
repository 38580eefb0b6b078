"""The train and validation steps (the JAX package's ``train/steps.py``).

One call covers the whole step: decode of the compact batch, frozen HNED
edge extraction, normalization, input assembly, the random horizontal flip
(train), the model forward, the 3-term loss ``w_l1*L1 +
w_style*(VGG+SSIM+Grad) + w_seg*CE``, and then the confusion matrix
(validation) or the gradients and the optimizer update (train). On the card
every 3x3 conv of GridNet, HNED and VGG19 is a launch of kernel A or B, the
SSIM term of the validation step one launch of the fused SSIM kernel, and
every InstanceNorm of a pix2pix generator a launch of the InstanceNorm
kernels, forward and backward; the gradient of the VGG19 term runs back
through kernel A.

The train step takes a GridNet or CoordGridNet as well as a pix2pix
generator. A GridNet's forward is 31 launches of kernel A and 15 of kernel
B; their backward is the library's VJP (cuDNN in bf16 on the card,
recomputed from the saved inputs, as the JAX package's ``custom_vjp``s take
``jax.vjp`` of the XLA conv), and a step launches kernel A 93 times in all:
31 for GridNet, 2 x 13 for HNED, 2 x 12 for the VGG19 forwards and 12 for
its data gradient. A pix2pix generator's convs are the library's, as in
the JAX package.

The train steps record the spans ``step.inputs`` (decode, edges, flip),
``step.forward`` (the loss), ``step.backward`` (``autograd.grad``) and
``step.update`` (the optimizer) while a profiler records
(``utils/profiling.py:annotate``); the K-step and scheduled-sampling steps
share them.

The flip is one coin per step over the whole batch (``flip_mode="batch"``),
one per example (``"per_example"``) or none.

Under a process group (one rank a card, ``parallel/mesh.py``) each rank
runs the step on its rows of the global batch: its loss is its share of
the global loss (``parallel/collectives.py:plain_share``), the gradients
and the metric shares are summed over the ranks in one flat all-reduce
before the update, and a per-example coin is drawn at the global batch's
shape, each rank taking its rows: the step of one process on the
concatenated batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..device import require_bf16, resolve_device
from ..evaluation.metrics import confusion_matrix
from ..losses.ce import cross_entropy_loss
from ..losses.pixel import l1_loss
from ..models.blocks import Conv3x3
from ..models.hned import hned_fused_edge
from ..parallel.collectives import draw_rows, plain_share, sum_over_ranks
from ..utils.profiling import annotate
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


def prepare_inputs(hned: Optional[Callable],
                   batch: Mapping[str, torch.Tensor]):
    """Edges + normalization + channel assembly -> (x, frame3 normalized).
    ``hned`` is a port HNED or None (8-channel input)."""
    f1, f2, f3 = batch["img1"], batch["img2"], batch["img3"]
    s1, s2 = batch["seg1"], batch["seg2"]
    if hned is not None:
        e1 = hned_fused_edge(hned, f1)
        e2 = hned_fused_edge(hned, f2)
    else:
        e1 = e2 = None
    f1n, f2n, f3n = (normalize_image(f) for f in (f1, f2, f3))
    return assemble_model_input(s1, f1n, f2n, s2, e1, e2), f3n


def make_loss_fn(model: Callable, combined_loss, w_l1: float = 40.0,
                 w_style: float = 20.0, w_seg: float = 10.0):
    """Build ``loss_fn(x, f3n, s3) -> (loss, (metrics, seg_logits,
    img_n))``."""

    def loss_fn(x, f3n, s3):
        seg_logits, img = model(x)
        img_n = normalize_model_output(img)
        loss_l1 = l1_loss(img_n, f3n) * w_l1
        loss_style = combined_loss(img_n, f3n) * w_style
        loss_seg = cross_entropy_loss(seg_logits, s3) * w_seg
        total = loss_l1 + loss_style + loss_seg
        metrics = {"loss": total, "loss_l1": loss_l1,
                   "loss_style": loss_style, "loss_seg": loss_seg}
        return total, (metrics, seg_logits, img_n)

    return loss_fn


def _flip_w(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip: W is axis -2 of an NHWC tensor and axis -1 of an
    (N, H, W) integer map."""
    if x.ndim == 4:
        return x.flip(-2)
    if x.ndim == 3:
        return x.flip(-1)
    return x


def _maybe_flip(coin, *tensors):
    """``coin`` a bool flips all tensors or none; a bool tensor (N,) flips
    the examples it marks."""
    if isinstance(coin, torch.Tensor) and coin.ndim == 1:
        return tuple(torch.where(
            coin.reshape((-1,) + (1,) * (t.ndim - 1)), _flip_w(t), t)
            for t in tensors)
    return tuple(map(_flip_w, tensors)) if bool(coin) else tuple(tensors)


def flip_coin(flip_mode: str, n: int, generator, device):
    """The step's coin: a bool for ``batch``, a bool tensor (n,) on
    ``device`` for ``per_example`` (this rank's n rows of the global
    batch's draw), None for ``none``. Drawn on the CPU from ``generator``
    (the global generator when None), so that a step never waits for the
    device to learn its coin."""
    if flip_mode == "none":
        return None
    if flip_mode == "batch":
        return bool(torch.rand((), generator=generator) < 0.5)
    if flip_mode == "per_example":
        coins = draw_rows(lambda m: torch.rand(m, generator=generator), n)
        return (coins < 0.5).to(device)
    raise ValueError(f"unknown flip_mode {flip_mode!r}")


def place_nets(model: torch.nn.Module, hned: Optional[torch.nn.Module],
               combined_loss, device) -> torch.device:
    """The step factories' placement: resolve ``device``, run
    ``require_bf16`` over the frozen nets (``hned``, the VGG19 trunk of
    ``combined_loss``) and over ``model`` where its convs are kernels A and
    B (a GridNet), so that a net built with another dtype raises by name
    here and not inside its first conv; move the nets there and set the
    frozen ones to eval mode. Returns the device."""
    dev = resolve_device(device)
    frozen = {"HNED": hned,
              "the VGG19 trunk of CombinedLoss": combined_loss.vgg_model}
    checked = frozen
    if any(isinstance(m, Conv3x3) for m in model.modules()):
        checked = {type(model).__name__: model, **frozen}
    require_bf16(dev, checked)
    model.to(dev)
    for net in frozen.values():
        if net is not None:
            net.to(dev).eval()
    return dev


def make_train_step(model: torch.nn.Module, hned: Optional[torch.nn.Module],
                    combined_loss, w_l1: float = 40.0, w_style: float = 20.0,
                    w_seg: float = 10.0, flip_mode: str = "batch",
                    device="cuda",
                    generator: Optional[torch.Generator] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is a ``TrainState`` over ``model``'s parameters
    (``TrainState.create(model, tx)`` after the nets are on ``device``; this
    call moves them there). The step computes the loss and its gradients and
    updates the parameters and the optimizer state in place; ``metrics``
    holds the detached loss terms on the device. ``generator`` draws the
    flip's coin. The model always runs with ``train=False`` (no dropout,
    running averages in a BatchNorm generator), as the JAX step applies it.
    A CUDA device raises for a net not built for bf16, GridNet included
    (``place_nets``)."""
    if flip_mode not in ("batch", "per_example", "none"):
        raise ValueError(f"unknown flip_mode {flip_mode!r}")
    dev = place_nets(model, hned, combined_loss, device)
    loss_fn = make_loss_fn(model, combined_loss, w_l1, w_style, w_seg)

    def train_step(state, batch):
        with annotate("step.inputs"), torch.no_grad():
            batch = decode_batch(_to_device(batch, dev))
            x, f3n = prepare_inputs(hned, batch)
            s3 = batch["seg3"]
            coin = flip_coin(flip_mode, x.shape[0], generator, dev)
            if coin is not None:
                x, f3n, s3 = _maybe_flip(coin, x, f3n, s3)
        with annotate("step.forward"), torch.enable_grad():
            total, (metrics, _, _) = loss_fn(x, f3n, s3)
        return apply_shared(state, total, metrics)

    return train_step


def apply_shared(state, total: torch.Tensor, metrics,
                 shares: bool = False) -> tuple:
    """One update from this rank's rows: the gradients of the rank's share
    of the loss, summed over the ranks with the metric shares (one
    all-reduce), then the optimizer's step. ``total`` and ``metrics`` are
    plain batch means over the rank's rows, or with ``shares`` already the
    rank's shares (``losses/vae.py:vae_loss``). Returns (state, the global
    batch's detached metrics)."""
    if not shares:
        total = plain_share(total)
        metrics = {k: plain_share(v) for k, v in metrics.items()}
    names = list(state.params)
    with annotate("step.backward"), torch.enable_grad():
        grads = torch.autograd.grad(total, [state.params[k] for k in names])
    grads, metrics = sum_over_ranks(
        dict(zip(names, grads)), {k: v.detach() for k, v in metrics.items()})
    with annotate("step.update"):
        state.apply_gradients(grads)
    return state, metrics


def _to_device(batch: Mapping, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_eval_step(model: torch.nn.Module, hned: Optional[torch.nn.Module],
                   combined_loss, w_l1: float = 40.0, w_style: float = 20.0,
                   w_seg: float = 10.0, n_classes: Optional[int] = None,
                   device="cuda"):
    """Returns ``eval_step(batch) -> (metrics, seg_pred_ids, img_pred_norm)``.

    The three nets (``model``, ``hned`` or None, the VGG trunk of
    ``combined_loss``) are moved to ``device`` and set to eval mode here; a
    CUDA device raises when the process has none, or when a net was not
    built for bf16 (``place_nets``). ``batch`` maps names to numpy arrays
    or tensors (``packed6``, or ``img1..3`` / ``seg1..3``) and is moved
    there too. With ``n_classes`` set, ``metrics["cm"]`` carries the (C, C)
    confusion matrix [target, pred] of the batch. Everything returned stays
    on the device."""
    dev = place_nets(model, hned, combined_loss, device)
    model.eval()
    loss_fn = make_loss_fn(model, combined_loss, w_l1, w_style, w_seg)

    @torch.no_grad()
    def eval_step(batch):
        batch = decode_batch(_to_device(batch, dev))
        x, f3n = prepare_inputs(hned, batch)
        _, (metrics, seg_logits, img_n) = loss_fn(x, f3n, batch["seg3"])
        seg_ids = seg_logits.argmax(dim=-1)
        if n_classes is not None:
            metrics = dict(metrics, cm=confusion_matrix(
                seg_ids, batch["seg3"], n_classes))
        return metrics, seg_ids, img_n

    return eval_step
