"""Train steps of the variational and recurrent layout families (the JAX
package's ``train/vae_steps.py``): LayoutVAE autoencode, ConvLSTM
next-layout prediction and the KL-annealed CVAE, each single-step and
(CVAE, ConvLSTM) K-step.

A step computes the loss and its gradients and updates the parameters and
the optimizer state in place (``train/state.py``); metrics are detached and
stay on the device. beta and the capacity target are host floats read at
each call, as the JAX steps take them as traced scalars.

Randomness: the JAX steps take a threefry key; here the latent noise, the
prior feedback's noise and the layout corruption come from ``generator``
(on the device), or are handed in (``eps`` / ``noise``: tests pass the JAX
package's draws). The K-step steps draw everything before the loss runs
(``draw_cvae_noise``, ``draw_layout_corruption``). The argmax feedback
carries no gradient. With K=1 the K-step steps run the ops of the single
steps, bit for bit.

Under a process group each rank runs the step on its rows of the global
batch: the losses are its shares of the global batch's (``vae_loss``
makes its own, the other objectives are plain means), the gradients and
metric shares are summed over the ranks in one all-reduce before the
update, and every draw is made at the global batch's shape, each rank
taking its rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..losses.ce import cross_entropy_loss
from ..losses.vae import cvae_loss, vae_loss
from ..models.vae import latent_hw, one_hot_context
from ..ops.one_hot import seg_one_hot
from ..parallel.collectives import draw_rows
from .steps import apply_shared


def kl_anneal(step: int, warmup_steps: int = 1000,
              beta_max: float = 1.0, cycle_steps: int = 0) -> float:
    """Linear KL warmup 0 -> beta_max over ``warmup_steps``; with
    ``cycle_steps > 0`` cyclical annealing (Fu et al. 2019): each cycle
    ramps 0 -> beta_max over its first half, then holds."""
    if cycle_steps > 0:
        phase = (step % cycle_steps) / cycle_steps
        return beta_max * min(1.0, 2.0 * phase)
    return beta_max * min(1.0, step / max(warmup_steps, 1))


def capacity_schedule(step: int, c_max: float,
                      c_steps: int = 1000) -> float:
    """Linear KL capacity target 0 -> c_max nats over c_steps (Burgess et
    al. 2018), the VAE step's ``capacity``."""
    return c_max * min(1.0, step / max(c_steps, 1))


def _ids(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev).long()


def make_vae_train_step(model, n_classes: int = 20, free_bits: float = 0.0,
                        use_capacity: bool = False, class_weights=None,
                        device="cuda",
                        generator: Optional[torch.Generator] = None):
    """``step(state, seg_ids (N,H,W), beta[, capacity], eps=None) ->
    (state, metrics)``; ``capacity`` is taken (and needed) when
    ``use_capacity``. The collapse remedies (``losses/vae.py``) are fixed
    here; beta and the capacity target are read at each call."""
    dev = resolve_device(device)
    model.to(dev)
    if class_weights is not None:
        class_weights = torch.as_tensor(class_weights, dtype=torch.float32,
                                        device=dev)

    def step(state, seg_ids, beta: float, capacity: Optional[float] = None,
             eps: Optional[torch.Tensor] = None):
        if (capacity is not None) != use_capacity:
            raise TypeError("capacity is taken exactly when the step was "
                            "made with use_capacity=True")
        seg_ids = _ids(seg_ids, dev)
        with torch.enable_grad():
            logits, mu, logvar = model(seg_one_hot(seg_ids, n_classes), eps,
                                       generator)
            total, metrics = vae_loss(logits, seg_ids, mu, logvar, beta,
                                      free_bits=free_bits, capacity=capacity,
                                      class_weights=class_weights)
            return apply_shared(state, total, metrics, shares=True)

    return step


def make_cvae_train_step(model, n_classes: int = 20, device="cuda",
                         generator: Optional[torch.Generator] = None):
    """``step(state, ctx_ids (N,T,H,W), target_ids (N,H,W), beta, eps=None)
    -> (state, metrics)``."""
    dev = resolve_device(device)
    model.to(dev)

    def step(state, ctx_ids, target_ids, beta: float,
             eps: Optional[torch.Tensor] = None):
        ctx_ids, target_ids = _ids(ctx_ids, dev), _ids(target_ids, dev)
        # (N,T,H,W) -> the channel-stacked context (N,H,W,T*C)
        ctx = torch.cat([seg_one_hot(ctx_ids[:, i], n_classes)
                         for i in range(ctx_ids.shape[1])], -1)
        with torch.enable_grad():
            logits, q_stats, p_stats = model(
                ctx, seg_one_hot(target_ids, n_classes), eps, generator)
            total, metrics = cvae_loss(logits, target_ids, q_stats, p_stats,
                                       beta)
            return apply_shared(state, total, metrics)

    return step


def draw_layout_corruption(k: int, shape, n_classes: int,
                           layout_noise: float,
                           generator: Optional[torch.Generator],
                           device) -> Optional[dict]:
    """The corruption of the K-1 fed-back layouts: ``corrupt`` (K-1, *shape)
    bool, true with probability ``layout_noise``, and ``cls`` (same shape)
    int64 classes uniform in [0, n_classes); None when the lever is off."""
    if layout_noise <= 0.0 or k < 2:
        return None
    kw = dict(generator=generator, device=device)

    def full(m):
        return (k - 1, m) + tuple(shape[1:])

    # this rank's rows (axis 1) of the global batch's draws
    corrupt = draw_rows(lambda m: torch.rand(full(m), **kw), shape[0],
                        dim=1) < layout_noise
    cls = draw_rows(lambda m: torch.randint(0, n_classes, full(m), **kw),
                    shape[0], dim=1)
    return {"corrupt": corrupt, "cls": cls}


def draw_cvae_noise(k: int, n: int, hw, latent_dim: int, n_classes: int,
                    feedback: str, layout_noise: float,
                    generator: Optional[torch.Generator], device) -> dict:
    """Every draw of a K-step CVAE step, in this order: ``eps`` (K, N, h, w,
    latent) posterior noise of each step (step 0's is the single step's
    draw), ``gen_eps`` (K-1, ...) the prior feedback's noise (feedback
    "prior"), then ``draw_layout_corruption``'s ``corrupt`` and ``cls``."""
    lat = latent_hw(*hw) + (latent_dim,)
    kw = dict(generator=generator, device=device)
    # this rank's rows of the global batch's draws
    noise = {"eps": [draw_rows(lambda m: torch.randn((m,) + lat, **kw), n)
                     for _ in range(k)]}
    if feedback == "prior" and k > 1:
        noise["gen_eps"] = draw_rows(
            lambda m: torch.randn((k - 1, m) + lat, **kw), n, dim=1)
    corruption = draw_layout_corruption(k, (n,) + tuple(hw), n_classes,
                                        layout_noise, generator, device)
    if corruption is not None:
        noise.update(corruption)
    return noise


def _corrupted(nxt: torch.Tensor, noise: Optional[dict], i: int
               ) -> torch.Tensor:
    if noise is None or "corrupt" not in noise:
        return nxt
    return torch.where(noise["corrupt"][i], noise["cls"][i], nxt)


def make_cvae_multistep_train_step(model, n_classes: int = 20, k: int = 2,
                                   layout_noise: float = 0.0,
                                   feedback: str = "prior", device="cuda",
                                   generator: Optional[torch.Generator] = None
                                   ):
    """K-step exposure training of the CVAE: ``step(state, seg_ids
    (N,T,H,W) with T >= k+2, beta, noise=None) -> (state, metrics)``.

    Step i trains the full CVAE objective against frame i+2; for i > 0 the
    newest context frame is the model's own argmax prediction, decoded from
    the prior (``feedback="prior"``, what ``make_cvae_rollout`` feeds
    itself) or taken from the step's posterior decode (``"posterior"``),
    then corrupted to a uniform class with probability ``layout_noise``.
    The loss and every metric are the plain mean over the K steps.
    ``noise`` is ``draw_cvae_noise``'s dict; it is drawn from ``generator``
    when not given."""
    if feedback not in ("prior", "posterior"):
        raise ValueError(f"unknown feedback {feedback!r}")
    dev = resolve_device(device)
    model.to(dev)

    def step(state, seg_ids, beta: float, noise: Optional[dict] = None):
        seg_ids = _ids(seg_ids, dev)
        if noise is None:
            noise = draw_cvae_noise(k, seg_ids.shape[0], seg_ids.shape[2:4],
                                    model.latent_dim, n_classes, feedback,
                                    layout_noise, generator, dev)
        with torch.enable_grad():
            c1, c2 = seg_ids[:, 0], seg_ids[:, 1]
            totals, metric_sum = [], None
            for i in range(k):
                target = seg_ids[:, i + 2]
                ctx = one_hot_context(c1, c2, n_classes)
                logits, q_stats, p_stats = model(
                    ctx, seg_one_hot(target, n_classes), noise["eps"][i])
                total, metrics = cvae_loss(logits, target, q_stats, p_stats,
                                           beta)
                totals.append(total)
                metric_sum = (metrics if metric_sum is None else
                              {m: metric_sum[m] + metrics[m]
                               for m in metrics})
                if i + 1 < k:
                    with torch.no_grad():
                        gen_logits = (model.generate(ctx,
                                                     noise["gen_eps"][i])
                                      if feedback == "prior" else logits)
                        nxt = _corrupted(gen_logits.argmax(-1), noise, i)
                    c1, c2 = c2, nxt
            # a plain mean keeps the loss scale (and the warm-start
            # recipe's Adam-calibrated lr) of the single step
            inv_k = 1.0 / k
            loss = sum(totals) * inv_k
            metrics = {m: v * inv_k for m, v in metric_sum.items()}
            metrics["loss"] = loss
            return apply_shared(state, loss, metrics)

    return step


def make_convlstm_train_step(model, n_classes: int = 20, device="cuda"):
    """``step(state, ctx_ids (N,T,H,W), target_ids (N,H,W))``."""
    dev = resolve_device(device)
    model.to(dev)

    def step(state, ctx_ids, target_ids):
        ctx_oh = seg_one_hot(_ids(ctx_ids, dev), n_classes)
        with torch.enable_grad():
            loss = cross_entropy_loss(model(ctx_oh), _ids(target_ids, dev))
            return apply_shared(state, loss, {"loss": loss})

    return step


def make_convlstm_multistep_train_step(
        model, n_classes: int = 20, k: int = 2, layout_noise: float = 0.0,
        device="cuda", generator: Optional[torch.Generator] = None):
    """The K-step exposure objective of the deterministic ConvLSTM:
    ``step(state, seg_ids (N,T,H,W), noise=None)``; steps i > 0 see the
    model's own argmax as the newest context frame. ``noise`` is
    ``draw_layout_corruption``'s dict (or None), drawn from ``generator``
    when not given. With K=1 it is ``make_convlstm_train_step`` on the
    window's first triplet, bit for bit."""
    dev = resolve_device(device)
    model.to(dev)

    def step(state, seg_ids, noise: Optional[dict] = None):
        seg_ids = _ids(seg_ids, dev)
        if noise is None:
            noise = draw_layout_corruption(
                k, (seg_ids.shape[0],) + tuple(seg_ids.shape[2:4]),
                n_classes, layout_noise, generator, dev)
        with torch.enable_grad():
            c1, c2 = seg_ids[:, 0], seg_ids[:, 1]
            total = 0.0
            for i in range(k):
                logits = model(seg_one_hot(torch.stack([c1, c2], 1),
                                           n_classes))
                total = total + cross_entropy_loss(logits, seg_ids[:, i + 2])
                if i + 1 < k:
                    c1, c2 = c2, _corrupted(logits.detach().argmax(-1),
                                            noise, i)
            loss = total / k
            return apply_shared(state, loss, {"loss": loss})

    return step
