"""Scheduled sampling for single-step training (the JAX package's
``train/scheduled.py``).

Per example, with probability ``p``, the newest input frame and layout are
replaced by the model's own detached prediction from the window's earlier
frames, and the ordinary single-step loss applies (Bengio et al., 2015):

  teacher (no grad): (f0, s0, f1, s1) -> (f2_hat, s2_hat)
  mix:   f2* = where(mask, f2_hat, f2);  s2* likewise
  student (trained): (f1, s1, f2*, s2*) -> predict (f3, s3)

Data contract: the stacked window batch with T >= 4 frames (the last four
are used). Two forwards and one backward a step; on the card with edges
137 launches of kernel A (HNED on f0, f1 and f2*: 39; GridNet twice: 62;
VGG19 on output and target: 24, and its data gradient: 12) and 30 of B. The
JAX package also computes HNED on f2, which nothing reads; the port does
not.

The mask (N,1,1,1) is drawn on the device from ``noise_generator``, the
whole-batch coin on the host (``flip_coin``); the loss function takes both
as arguments, so tests hand it the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.hned import hned_fused_edge
from .assemble import (assemble_model_input, denormalize_image,
                       normalize_image, normalize_model_output)
from ..parallel.collectives import draw_rows
from ..utils.profiling import annotate
from .multistep import decode_window_batch
from .steps import (_maybe_flip, _to_device, apply_shared, flip_coin,
                    make_loss_fn, place_nets)


def make_scheduled_loss_fn(model, hned, combined_loss, w_l1: float = 40.0,
                           w_style: float = 20.0, w_seg: float = 10.0):
    """Build ``loss_fn(imgs, segs, mask, coin) -> (loss, metrics)``: imgs (N,T,H,W,3) in [0,1], segs (N,T,H,W) int, T >= 4;
    mask (N,1,1,1) bool, true where the example gets its own prediction;
    coin a bool, the whole-batch flip applied after edge extraction."""
    use_edges = hned is not None
    loss_fn = make_loss_fn(model, combined_loss, w_l1, w_style, w_seg)

    def edge(frame):
        return hned_fused_edge(hned, frame.contiguous())

    def scheduled_loss(imgs, segs, mask, coin):
        if imgs.shape[1] < 4:
            raise ValueError("scheduled sampling needs >= 4-frame windows, "
                             f"got {imgs.shape[1]}")
        with torch.no_grad():
            f0, f1, f2, f3 = (imgs[:, i].contiguous() for i in range(-4, 0))
            f0n, f1n, f2n, f3n = (normalize_image(f)
                                  for f in (f0, f1, f2, f3))
            s0c, s1c, s2c = (segs[:, i].float()[..., None]
                             for i in (-4, -3, -2))
            s3 = segs[:, -1].contiguous()
            e0, e1 = (edge(f0), edge(f1)) if use_edges else (None, None)
            # teacher pass (detached): predict frame 2 from (0, 1)
            x_t = assemble_model_input(s0c, f0n, f1n, s1c, e0, e1)
            t_logits, t_img = model(x_t)
            f2_hat = normalize_model_output(t_img)
            s2_hat = t_logits.argmax(dim=-1).float()[..., None]
            f2_star = torch.where(mask, f2_hat, f2n)
            s2_star = torch.where(mask, s2_hat, s2c)
            # the edge of the mixed frame, as the rollout recomputes it
            e2_star = (edge(denormalize_image(f2_star)) if use_edges
                       else None)
            x = assemble_model_input(s1c, f1n, f2_star, s2_star, e1,
                                     e2_star)
            if coin:
                x, f3n, s3 = _maybe_flip(True, x, f3n, s3)
        total, (metrics, _, _) = loss_fn(x, f3n, s3)
        return total, metrics

    return scheduled_loss


def draw_sampling_mask(n: int, p: float,
                       generator: Optional[torch.Generator], device
                       ) -> torch.Tensor:
    """(n, 1, 1, 1) bool on ``device``, each true with probability p: this
    rank's n rows of the global batch's draw."""
    return draw_rows(lambda m: torch.rand((m, 1, 1, 1), generator=generator,
                                          device=device), n) < p


def make_scheduled_train_step(model: torch.nn.Module, hned, combined_loss,
                              w_l1: float = 40.0, w_style: float = 20.0,
                              w_seg: float = 10.0, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              noise_generator: Optional[torch.Generator]
                              = None):
    """Returns ``train_step(state, batch, p) -> (state, metrics)`` over the
    T >= 4 window contract (the nets move to ``device``, the state updates
    in place, ``metrics`` adds ``ss_p``). ``p`` in [0, 1] is the
    probability that an example's newest input pair is the model's own
    prediction; the mask comes from ``noise_generator`` (on ``device``),
    the coin from ``generator`` (host)."""
    dev = place_nets(model, hned, combined_loss, device)
    loss_fn = make_scheduled_loss_fn(model, hned, combined_loss, w_l1,
                                     w_style, w_seg)

    def train_step(state, batch, p: float):
        with annotate("step.inputs"):
            with torch.no_grad():
                imgs, segs = decode_window_batch(_to_device(batch, dev))
            n = imgs.shape[0]
            mask = draw_sampling_mask(n, p, noise_generator, dev)
            coin = flip_coin("batch", n, generator, dev)
        with annotate("step.forward"), torch.enable_grad():
            total, metrics = loss_fn(imgs, segs, mask, coin)
        state, metrics = apply_shared(state, total, metrics)
        metrics["ss_p"] = p
        return state, metrics

    return train_step


def scheduled_p(epoch: int, p_final: float, ramp_epochs: int) -> float:
    """Linear ramp 0 -> p_final over ``ramp_epochs`` (0 = constant)."""
    if ramp_epochs <= 0:
        return p_final
    return p_final * min(1.0, (epoch + 1) / ramp_epochs)
