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

While a profiler records, the step records the spans ``step.inputs``
(decode, edges, flip, the real pair), ``step.forward`` (the generator's
forward), ``gan.disc`` (both D forwards, D's loss and gradients),
``gan.disc_update`` (D's all-reduce and optimizer), ``gan.adv`` (the frozen
D's forward and G's four loss terms), ``step.backward`` (G's gradients) and
``step.update`` (G's optimizer) (``utils/profiling.py:annotate``). The
returned step counts its D forwards by role in ``gan_step.disc_forwards``
(``fake``, ``real``, ``adv``, and ``penalty`` under wgangp), over its life;
the Trainer reports an epoch's counts.

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
from ..utils.profiling import annotate
from .state import TrainState
from .steps import (_maybe_flip, _to_device, decode_batch, flip_coin,
                    place_nets, prepare_inputs)


DISC_ROLES = ("fake", "real", "adv", "penalty")


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

    disc_forwards = dict.fromkeys(DISC_ROLES, 0)

    def run_d(z, role: str, update_stats: bool = True):
        disc_forwards[role] += 1
        return disc(z, train=disc_batch_stats, update_stats=update_stats)

    def gan_step(state: GanTrainState, batch):
        with annotate("step.inputs"), torch.no_grad():
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

        # ---- the generator forward, once --------------------------------
        with annotate("step.forward"), torch.enable_grad():
            seg_logits, img = gen(x)
            img_n = normalize_model_output(img)
            fake_detached = torch.cat([f1n, f2n, img_n.detach()], dim=-1)

        # ---- D update ---------------------------------------------------
        with annotate("gan.disc"), torch.enable_grad():
            loss_d_fake = gan_loss(run_d(fake_detached, "fake"), False,
                                   gan_mode)
            loss_d_real = gan_loss(run_d(real_pair, "real"), True, gan_mode)
            loss_d = 0.5 * (loss_d_fake + loss_d_real)
            if gan_mode == "wgangp":
                pen, _ = gradient_penalty(
                    lambda z: run_d(z, "penalty", update_stats=False),
                    real_pair, fake_detached, gp_generator,
                    lambda_gp=lambda_gp)
                loss_d = loss_d + pen
            d_grads = _grads(loss_d, state.disc)
        with annotate("gan.disc_update"):
            d_grads, d_metrics = sum_over_ranks(d_grads, _shares(
                {"loss_d": loss_d, "loss_d_fake": loss_d_fake,
                 "loss_d_real": loss_d_real}))
            state.disc.apply_gradients(d_grads)

        # ---- G update, against the updated D ----------------------------
        with annotate("gan.adv"), torch.enable_grad():
            for p in state.disc.params.values():
                p.requires_grad_(False)
            try:
                pred_fake = run_d(torch.cat([f1n, f2n, img_n], dim=-1),
                                  "adv")
            finally:
                for p in state.disc.params.values():
                    p.requires_grad_(True)
            loss_gan = gan_loss(pred_fake, True, gan_mode)
            loss_l1 = l1_loss(img_n, f3n) * w_l1
            loss_style = combined_loss(img_n, f3n) * w_style
            loss_seg = cross_entropy_loss(seg_logits, s3) * w_seg
            loss_g = loss_gan + loss_l1 + loss_style + loss_seg
        with annotate("step.backward"), torch.enable_grad():
            g_grads = _grads(loss_g, state.gen)
        g_grads, g_metrics = sum_over_ranks(g_grads, _shares(
            {"loss_gan": loss_gan, "loss_l1": loss_l1,
             "loss_style": loss_style, "loss_seg": loss_seg,
             "loss": loss_g}))
        with annotate("step.update"):
            state.gen.apply_gradients(g_grads)
        return state, {**g_metrics, **d_metrics}

    gan_step.disc_forwards = disc_forwards
    return gan_step
