"""The training step in plain float32: loss, gradients and Adam, for one
step on triplets (K = 1) and for the K-step rollout-fidelity recipe.

The objective is the reference repository's (``src/trainer.py``):
``w_l1 * L1 + w_style * (VGG + gradient + SSIM) + w_seg * CE`` of the
predicted frame and layout against the third frame, with the two frozen
nets (HED edges of the seed frames as two extra input channels; VGG19
features to relu4_4 for the perceptual term). What the port derives from
the inputs, this module works out again from the same inputs: the flip's
coin and the K-step feedback noise from (seed, step) (``step_seed``), the
rows of each step from the loader's shuffle.

The batch mean is taken in blocks of rows, each block's loss weighted by
its share of the batch, so that a step at the timed batch fits beside the
card's other memory; gradients are summed over the blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import nets

C1 = 0.01 ** 2
C2 = 0.03 ** 2
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


# ---- what the port derives from (seed, step) and the loader's shuffle -------

def step_seed(seed: int, step: int) -> int:
    """The seed of global step ``step``'s draws."""
    return ((seed & 0xFFFFFFFF) << 31 | (step & 0x7FFFFFFF)) & (2 ** 63 - 1)


def flip_coin(seed: int, step: int) -> bool:
    """One coin over the whole batch, drawn on the host."""
    g = torch.Generator().manual_seed(step_seed(seed, step))
    return bool(torch.rand((), generator=g) < 0.5)


def feedback_noise(seed: int, step: int, k: int, n: int, hw, device
                   ) -> torch.Tensor:
    """(K-1, N, H, W, 3) unit normals, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    return torch.randn((k - 1, n) + tuple(hw) + (3,), generator=g,
                       device=device)


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The dataset indices of one epoch, in the order they are batched."""
    return np.random.default_rng((seed << 16) ^ epoch).permutation(n)


# ---- the loss ---------------------------------------------------------------

def l1_loss(a, b):
    return (a - b).abs().mean()


def gradient_loss(a, b):
    def d(dim, x):
        n = x.shape[dim]
        return (x.narrow(dim, 1, n - 1) - x.narrow(dim, 0, n - 1)).abs()
    x = (d(-2, a) - d(-2, b)).abs().sum()
    y = (d(-1, a) - d(-1, b)).abs().sum()
    return (x + y) / a.numel()


def ssim_loss(x, y):
    """Sum over channels of the batch mean of clip((1 - SSIM) / 2, 0, 1),
    3 x 3 valid window means."""
    stats = torch.cat([x, y, x * x, y * y, x * y], dim=1)
    mx, my, xx, yy, xy = F.avg_pool2d(stats, 3, 1).chunk(5, dim=1)
    sx, sy, sxy = xx - mx * mx, yy - my * my, xy - mx * my
    num = (2 * mx * my + C1) * (2 * sxy + C2)
    den = (mx * mx + my * my + C1) * (sx + sy + C2)
    val = ((1.0 - num / den) / 2.0).clamp(0.0, 1.0)
    return val.mean(dim=(2, 3)).mean(dim=0).sum()


class Nets:
    """The three parameter dicts and the conv hooks of ``nets.py``."""

    def __init__(self, gen: Dict, hned: Dict, vgg: Dict, q=None, rec=None):
        self.gen, self.hned, self.vgg = gen, hned, vgg
        self.q, self.rec = q, rec

    def gridnet(self, x):
        return nets.gridnet(self.gen, x, self.q, self.rec)

    def edge(self, rgb):
        with torch.no_grad():
            return nets.hned_edge(self.hned, rgb, self.q, self.rec)

    def features(self, x):
        return nets.vgg_features(self.vgg, x, self.q, self.rec)


def terms(nt: Nets, x, f3n, s3, w: Sequence[float]):
    """(L1, style, CE) weighted, the logits and the normalized frame."""
    seg, img = nt.gridnet(x)
    img_n = nets.normalize_model_output(img)
    with torch.no_grad():
        ft = nt.features(f3n)
    style = ((nt.features(img_n) - ft).abs().mean() + gradient_loss(img_n, f3n)
             + ssim_loss(img_n, f3n))
    out = torch.stack([l1_loss(img_n, f3n) * w[0], style * w[1],
                       F.cross_entropy(seg, s3) * w[2]])
    return out, seg, img_n


def _flip(t):      # W of an NHWC tensor or of an (N, H, W) map
    return t.flip(-2) if t.ndim == 4 else t.flip(-1)


def _flip_nchw(t):
    return t.flip(-1)


def triplet_loss(nt: Nets, imgs, segs, coin: bool, w) -> torch.Tensor:
    """The weighted (L1, style, CE) terms of one step on triplets. imgs
    (N, 3, H, W, 3) in [0, 1]; segs (N, 3, H, W) int64. Edges from the
    unflipped frames, then the input, target frame and target layout flip
    together."""
    with torch.no_grad():
        e1, e2 = nt.edge(imgs[:, 0]), nt.edge(imgs[:, 1])
        fn = [nets.normalize_image(imgs[:, i].permute(0, 3, 1, 2))
              for i in range(3)]
        x = nets.model_input(e1, segs[:, 0], fn[0], fn[1], segs[:, 1], e2)
        f3n, s3 = fn[2], segs[:, 2]
        if coin:
            x, f3n, s3 = _flip(x), _flip_nchw(f3n), _flip(s3)
    return terms(nt, x, f3n, s3, w)[0]


def kstep_loss(nt: Nets, imgs, segs, coin: bool, noise, sigma: float, k: int,
               w) -> torch.Tensor:
    """The weighted terms of the K-step loss: K autoregressive steps from
    the two seed frames, each fed back its predicted frame (plus ``sigma``
    times ``noise[i]``, normalized space, differentiably), its argmax
    layout (detached) and the HED edges of the fed-back frame (no
    gradient); the mean over the steps of each weighted term."""
    with torch.no_grad():
        f = [nets.normalize_image(imgs[:, i].permute(0, 3, 1, 2))
             for i in range(k + 2)]
        s = [segs[:, i] for i in range(k + 2)]
        e = [nt.edge(imgs[:, 0]), nt.edge(imgs[:, 1])]
        if coin:
            f = [_flip_nchw(t) for t in f]
            s = [_flip(t) for t in s]
            e = [_flip(t) for t in e]
    f_o, f_n, s_o, s_n, e_o, e_n = f[0], f[1], s[0], s[1], e[0], e[1]
    per_step = []
    for i in range(k):
        x = nets.model_input(e_o, s_o, f_o, f_n, s_n, e_n)
        t, seg, img_n = terms(nt, x, f[2 + i], s[2 + i], w)
        per_step.append(t)
        if i == k - 1:
            break
        with torch.no_grad():
            s_next = seg.argmax(dim=1)
        fb = img_n + sigma * noise[i].permute(0, 3, 1, 2)
        e_next = nt.edge(nets.denormalize_image(fb.detach())
                         .permute(0, 2, 3, 1).contiguous())
        f_o, f_n, s_o, s_n, e_o, e_n = f_n, fb, s_n, s_next, e_n, e_next
    return torch.stack(per_step).mean(dim=0)


# ---- gradients and Adam -----------------------------------------------------

def loss_and_grads(params: Dict[str, torch.Tensor], loss_of: Callable,
                   n: int, block: int):
    """The batch loss's terms and the gradients of their sum, in blocks of
    ``block`` rows: ``loss_of(rows)`` is the terms of those rows (means
    over them)."""
    leaves = [params[k] for k in params]
    total = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for r0 in range(0, n, block):
        rows = slice(r0, min(n, r0 + block))
        share = (rows.stop - rows.start) / n
        with torch.enable_grad():
            t = loss_of(rows) * share
            g = torch.autograd.grad(t.sum(), leaves)
        total = total + t.detach()
        for acc, gi in zip(grads, g):
            acc.add_(gi)
    return total.tolist(), dict(zip(params, grads))


class Adam:
    """Adam with bias correction of both moments and ``eps`` added to the
    root of the corrected second moment, in float32."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float):
        self.lr, self.b1, self.t = lr, b1, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - ADAM_B2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            p.sub_(self.lr * (self.m[k] / c1)
                   / ((self.v[k] / c2).sqrt() + ADAM_EPS))


def follow_steps(nt: Nets, batches: List[dict], lr: float, b1: float,
                 block: int) -> dict:
    """Run the steps of ``batches`` from ``nt.gen`` (updated in place).
    Each batch holds ``loss_of(nt, rows)`` and ``n``. Returns each step's
    loss, the first step's gradient norm of each leaf, and each leaf's
    change over all the steps."""
    p0 = {k: v.detach().clone() for k, v in nt.gen.items()}
    for v in nt.gen.values():
        v.requires_grad_(True)
    opt = Adam(nt.gen, lr, b1)
    losses, g1 = [], None
    for b in batches:
        t, grads = loss_and_grads(
            nt.gen, lambda rows, b=b: b["loss_of"](nt, rows), b["n"],
            block)
        losses.append(sum(t))
        if g1 is None:
            g1 = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(nt.gen, grads)
    change = {k: float((nt.gen[k].detach() - p0[k]).norm()) for k in p0}
    return dict(losses=losses, grad_norms=g1, change_norms=change)
