"""Adversarial training: alternating G/D updates in one step (the JAX
package's ``train/gan.py``).

- D update: fake pair ``cat(frame1, frame2, G(x).img)`` with the generated
  frame detached, real pair ``cat(frame1, frame2, frame3)``;
  ``loss_D = 0.5 * (GAN(pred_fake, False) + GAN(pred_real, True))``
  (+ the WGAN-GP gradient penalty when ``gan_mode == "wgangp"``).
- G update: ``GAN(D(fake_pair), True)`` + the 3-term reconstruction loss,
  evaluated against the D parameters *after* the D update.

The generator forward runs once and serves both halves. A BatchNorm
discriminator runs in train mode and its running statistics (buffers of the
module, ``GanTrainState.disc_stats``) move in the order fake forward, real
forward, G-side forward; the WGAN-GP interpolate forward does not move them.
On the card every InstanceNorm of both nets is a launch of the InstanceNorm
kernels, forward and backward, and the penalty's second derivative runs
through the backward kernel's own closed-form backward. A GridNet or
CoordGridNet generator runs kernels A and B once a step, in its one
forward (31 and 15 launches), with the library's VJP as their backward
(``train/steps.py``).

Under a process group each rank's D and G losses are its shares of the
global batch's (plain means), and each update sums its gradients and
metric shares over the ranks in one flat all-reduce: two a step. A
BatchNorm discriminator's statistics would be the rank's, not the global
batch's, so it is refused over more than one rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..losses.ce import cross_entropy_loss
from ..losses.gan import gan_loss, gradient_penalty
from ..losses.pixel import l1_loss
from .assemble import normalize_image, normalize_model_output
from ..parallel.collectives import plain_share, sum_over_ranks
from ..parallel.mesh import process_count
from .state import TrainState
from .steps import (_maybe_flip, _to_device, decode_batch, flip_coin,
                    place_nets, prepare_inputs)


@dataclass
class GanTrainState:
    gen: TrainState
    disc: TrainState

    @property
    def step(self) -> int:
        return self.gen.step

    @property
    def disc_stats(self) -> Optional[dict]:
        """The discriminator's BatchNorm running statistics (its module's
        buffers), or None where it has none."""
        if self.disc.module is None:
            return None
        return dict(self.disc.module.named_buffers()) or None


def _grads(loss: torch.Tensor, state: TrainState) -> dict:
    names = list(state.params)
    return dict(zip(names, torch.autograd.grad(
        plain_share(loss), [state.params[k] for k in names])))


def _shares(metrics: dict) -> dict:
    return {k: plain_share(v.detach()) for k, v in metrics.items()}


def make_gan_train_step(gen: torch.nn.Module, disc: torch.nn.Module,
                        hned: Optional[torch.nn.Module], combined_loss,
                        gan_mode: str = "lsgan", w_l1: float = 40.0,
                        w_style: float = 20.0, w_seg: float = 10.0,
                        lambda_gp: float = 10.0, flip_mode: str = "batch",
                        disc_batch_stats: bool = False, device="cuda",
                        generator: Optional[torch.Generator] = None,
                        gp_generator: Optional[torch.Generator] = None):
    """Returns ``gan_step(state, batch) -> (state, metrics)`` for a
    ``GanTrainState`` over ``gen``'s and ``disc``'s parameters. Both nets,
    ``hned`` and the VGG trunk are moved to ``device`` here; the states are
    updated in place.

    ``disc_batch_stats=True`` for a BatchNorm discriminator. ``generator``
    draws the flip's coin (on the CPU), ``gp_generator`` the penalty's mixing
    weights (on ``device``)."""
    if flip_mode not in ("batch", "per_example", "none"):
        raise ValueError(f"unknown flip_mode {flip_mode!r}")
    if disc_batch_stats and process_count() > 1:
        raise ValueError("a BatchNorm discriminator needs the global batch's "
                         "statistics, which are not gathered across ranks; "
                         "use --norm instance over more than one rank")
    dev = place_nets(gen, hned, combined_loss, device)
    disc.to(dev)

    def run_d(z, update_stats: bool = True):
        return disc(z, train=disc_batch_stats, update_stats=update_stats)

    def gan_step(state: GanTrainState, batch):
        with torch.no_grad():
            batch = decode_batch(_to_device(batch, dev))
            x, f3n = prepare_inputs(hned, batch)
            s3 = batch["seg3"]
            f1n = normalize_image(batch["img1"])
            f2n = normalize_image(batch["img2"])
            coin = flip_coin(flip_mode, x.shape[0], generator, dev)
            if coin is not None:
                x, f3n, s3, f1n, f2n = _maybe_flip(coin, x, f3n, s3, f1n,
                                                   f2n)
            real_pair = torch.cat([f1n, f2n, f3n], dim=-1)

        with torch.enable_grad():
            # ---- the generator forward, once ----------------------------
            seg_logits, img = gen(x)
            img_n = normalize_model_output(img)
            fake_detached = torch.cat([f1n, f2n, img_n.detach()], dim=-1)

            # ---- D update -----------------------------------------------
            loss_d_fake = gan_loss(run_d(fake_detached), False, gan_mode)
            loss_d_real = gan_loss(run_d(real_pair), True, gan_mode)
            loss_d = 0.5 * (loss_d_fake + loss_d_real)
            if gan_mode == "wgangp":
                pen, _ = gradient_penalty(
                    lambda z: run_d(z, update_stats=False), real_pair,
                    fake_detached, gp_generator, lambda_gp=lambda_gp)
                loss_d = loss_d + pen
            d_grads = _grads(loss_d, state.disc)
        d_grads, d_metrics = sum_over_ranks(d_grads, _shares(
            {"loss_d": loss_d, "loss_d_fake": loss_d_fake,
             "loss_d_real": loss_d_real}))
        state.disc.apply_gradients(d_grads)

        with torch.enable_grad():
            # ---- G update, against the updated D ------------------------
            for p in state.disc.params.values():
                p.requires_grad_(False)
            try:
                pred_fake = run_d(torch.cat([f1n, f2n, img_n], dim=-1))
            finally:
                for p in state.disc.params.values():
                    p.requires_grad_(True)
            loss_gan = gan_loss(pred_fake, True, gan_mode)
            loss_l1 = l1_loss(img_n, f3n) * w_l1
            loss_style = combined_loss(img_n, f3n) * w_style
            loss_seg = cross_entropy_loss(seg_logits, s3) * w_seg
            loss_g = loss_gan + loss_l1 + loss_style + loss_seg
            g_grads = _grads(loss_g, state.gen)
        g_grads, g_metrics = sum_over_ranks(g_grads, _shares(
            {"loss_gan": loss_gan, "loss_l1": loss_l1,
             "loss_style": loss_style, "loss_seg": loss_seg,
             "loss": loss_g}))
        state.gen.apply_gradients(g_grads)
        return state, {**g_metrics, **d_metrics}

    return gan_step
