"""The pix2pix GAN step on the ResNet-9 generator as plain float32 functions
of parameter dicts: the 70x70 PatchGAN, the GAN losses and the alternating
D / G updates with their Adams.

Written from the published nets and step (Isola et al. 2017,
arXiv:1611.07004; junyanz/pytorch-CycleGAN-and-pix2pix
``models/networks.py`` ``NLayerDiscriminator`` with ``n_layers=3`` and
``GANLoss``, ``models/pix2pix_model.py`` ``optimize_parameters``) and not
from the port:

- the discriminator: 4 x 4 convs with zero padding 1, 9 -> 64 -> 128 ->
  256 at stride 2, 256 -> 512 and 512 -> 1 at stride 1 (256 px in, 30 x 30
  patch logits out); LeakyReLU 0.2 after every conv but the last; a
  non-affine InstanceNorm (mean and biased variance of each (sample,
  channel) plane, ``resnet_gen.EPS``) after convs 1-3; every conv has a
  bias (pix2pix's ``use_bias`` with InstanceNorm);
- ``GANLoss``: ``lsgan`` the mean square of every patch logit against 1
  (real) or 0 (fake), ``vanilla`` the mean binary cross-entropy with
  logits against them;
- one step: the generator's forward once; ``loss_D = 0.5 * (GAN(D(fake
  detached), 0) + GAN(D(real), 1))``, D's gradients and D's Adam; then
  ``loss_G = GAN(D'(fake), 1) + w_l1 * L1 + w_style * (VGG + gradient +
  SSIM) + w_seg * CE`` against the updated D' with D's parameters frozen
  (pix2pix's ``set_requires_grad(netD, False)``), G's gradients through D'
  and G's Adam. Both Adams as pix2pix sets them (the same lr and beta1).

The reference repository (gongaa/video-layout-generation) carries the
same nets and loss (``src/models/networks.py:546-591`` and ``:209-275``)
and their flags (``src/main.py:147-158``). Departures from pix2pix, each
that repository's or the train step's:

- the condition is two past frames: D sees (frame 1, frame 2, frame 3 or
  the generated frame 3), 9 channels, each frame ImageNet-normalized (the
  generated one mapped there from tanh), where pix2pix pairs one input
  image with one output image in [-1, 1];
- G's reconstruction is the repository's three terms (40 L1 + 20 style +
  10 CE, ``train.terms``) where pix2pix has 100 L1, and the generator has
  the repository's two heads (``resnet_gen.py``);
- no dropout: the step runs the generator with ``train=False``.

The batch mean is taken in blocks of rows, as ``train.loss_and_grads``
takes it. So the generator's forward runs twice: once without gradients
for the fake pairs D is trained on, and once with them for G's loss. Both
give the same values. Parameters are named as the port's ``state_dict``
names them (``Conv_0`` ... ``Conv_4``), kernels in flax's layout (kh, kw,
Ci, Co). The hooks are ``resnet_gen.py``'s: ``q`` rounds every conv's input
and kernel (the control), ``norm_rec(n, h, w, c)`` is called once for each
InstanceNorm (``gan_counts.py``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F

from . import nets, train
from .resnet_gen import Nets, _conv_spec, _Gen, generator

Params = Dict[str, torch.Tensor]
FAULTS = ("stale_disc", "swapped_targets")


def disc_spec(n_in: int = 9, ndf: int = 64, n_layers: int = 3) -> list:
    """(name, shape, kind) of every parameter of the PatchGAN."""
    widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
    spec = _conv_spec("Conv_0", 4, n_in, ndf)
    for n in range(1, n_layers + 1):
        spec += _conv_spec(f"Conv_{n}", 4, widths[n - 1], widths[n])
    return spec + _conv_spec(f"Conv_{n_layers + 1}", 4, widths[-1], 1)


def disc_spec_of(config: dict) -> list:
    return disc_spec(config["disc_input_nc"], config["ndf"],
                     config["n_layers_D"])


def discriminator(p: Params, x_nchw: torch.Tensor, q=None, norm_rec=None
                  ) -> torch.Tensor:
    """x (N, C, H, W) -> patch logits (N, 1, h, w)."""
    d = _Gen(p, q, norm_rec)
    n_layers = sum(1 for k in p if k.endswith(".kernel")) - 2
    y = F.leaky_relu(d.conv(x_nchw, "Conv_0", stride=2, padding=1), 0.2)
    for n in range(1, n_layers + 1):
        y = d.conv(y, f"Conv_{n}", stride=2 if n < n_layers else 1,
                   padding=1)
        y = F.leaky_relu(d.norm(y), 0.2)
    return d.conv(y, f"Conv_{n_layers + 1}", padding=1)


def gan_loss(pred: torch.Tensor, real: bool, mode: str) -> torch.Tensor:
    target = torch.full_like(pred, 1.0 if real else 0.0)
    if mode == "lsgan":
        return F.mse_loss(pred, target)
    if mode == "vanilla":
        return F.binary_cross_entropy_with_logits(pred, target)
    raise ValueError(f"the reference has no GAN loss {mode!r}")


def gan_inputs(nt: Nets, imgs, segs, coin: bool) -> dict:
    """The step's inputs, as ``train.triplet_loss`` makes them: the
    generator's input ``x``, the normalized frames ``f1n``, ``f2n``,
    ``f3n`` (NCHW) and the target layout ``s3``, flipped together."""
    with torch.no_grad():
        e1, e2 = nt.edge(imgs[:, 0]), nt.edge(imgs[:, 1])
        fn = [nets.normalize_image(imgs[:, i].permute(0, 3, 1, 2))
              for i in range(3)]
        x = nets.model_input(e1, segs[:, 0], fn[0], fn[1], segs[:, 1], e2)
        s3 = segs[:, 2]
        if coin:
            x, s3 = train._flip(x), train._flip(s3)
            fn = [train._flip_nchw(t) for t in fn]
    return dict(x=x, f1n=fn[0], f2n=fn[1], f3n=fn[2], s3=s3)


def pair(inp: dict, frame3: torch.Tensor) -> torch.Tensor:
    """D's 9-channel input: frames 1 and 2 with ``frame3``."""
    return torch.cat([inp["f1n"], inp["f2n"], frame3], dim=1)


def fake_frame(nt: Nets, inp: dict) -> torch.Tensor:
    """The generated frame 3, normalized, without gradients."""
    with torch.no_grad():
        return nets.normalize_model_output(generator(nt.gen, inp["x"],
                                                     nt.q)[1])


def d_loss(disc: Params, inp: dict, fake: torch.Tensor, mode: str, q=None,
           swapped: bool = False) -> torch.Tensor:
    """``0.5 * (GAN(D(fake), 0) + GAN(D(real), 1))``; ``swapped`` takes
    each against the other's target (a planted fault)."""
    f = gan_loss(discriminator(disc, pair(inp, fake.detach()), q), swapped,
                 mode)
    r = gan_loss(discriminator(disc, pair(inp, inp["f3n"]), q), not swapped,
                 mode)
    return 0.5 * (f + r)


def g_terms(nt: Nets, disc: Params, inp: dict, w, mode: str,
            swapped: bool = False) -> torch.Tensor:
    """G's four terms: the adversarial term against ``disc`` and the
    weighted L1, style and CE (``train.terms``), the generator's forward
    with gradients."""
    rec, _, img_n = train.terms(nt, inp["x"], inp["f3n"], inp["s3"], w)
    adv = gan_loss(discriminator(disc, pair(inp, img_n), nt.q), not swapped,
                   mode)
    return torch.cat([adv[None], rec])


def _requires_grad(params: Params, on: bool) -> None:
    for v in params.values():
        v.requires_grad_(on)


def steps(gen: Params, disc: Params, hned: Params, vgg: Params,
          batches: List[dict], lr: float, b1: float, block: int, mode: str,
          w, q=None, fault=None) -> Iterator[dict]:
    """The reference's steps of ``batches`` from the initial weights
    (float32, TF32 off; ``q``: the control's rounding; ``fault``: one of
    ``FAULTS`` planted, for the readings of the check). Each batch holds
    ``imgs`` (N, 3, H, W, 3) in [0, 1], ``segs`` (N, 3, H, W), ``coin`` and
    ``n``, the rows it uses. Yields after each step its G terms (adversarial,
    L1, style, CE) and D loss, and both nets' gradients and parameters by
    net (``gen``, ``disc``; the next step updates the parameters in
    place)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nt = Nets({k: v.detach().clone().float() for k, v in gen.items()},
              hned, vgg, q=q)
    dp = {k: v.detach().clone().float() for k, v in disc.items()}
    g_opt, d_opt = train.Adam(nt.gen, lr, b1), train.Adam(dp, lr, b1)
    swapped = fault == "swapped_targets"
    for b in batches:
        cache: Dict[int, dict] = {}

        def inputs(rows, b=b):
            if rows.start not in cache:
                cache[rows.start] = gan_inputs(nt, b["imgs"][rows],
                                               b["segs"][rows], b["coin"])
            return cache[rows.start]

        _requires_grad(nt.gen, False)
        _requires_grad(dp, True)
        t_d, d_grads = train.loss_and_grads(
            dp, lambda rows: d_loss(dp, inputs(rows),
                                    fake_frame(nt, inputs(rows)), mode, q,
                                    swapped)[None], b["n"], block)
        d_seen = ({k: v.detach().clone() for k, v in dp.items()}
                  if fault == "stale_disc" else dp)
        d_opt.step(dp, d_grads)
        _requires_grad(dp, False)
        _requires_grad(nt.gen, True)
        _requires_grad(d_seen, False)
        t_g, g_grads = train.loss_and_grads(
            nt.gen, lambda rows: g_terms(nt, d_seen, inputs(rows), w, mode,
                                         swapped), b["n"], block)
        g_opt.step(nt.gen, g_grads)
        yield dict(g_terms=t_g, d_loss=t_d[0],
                   grads={"gen": g_grads, "disc": d_grads},
                   params={"gen": nt.gen, "disc": dp})


def follow(gen: Params, disc: Params, hned: Params, vgg: Params,
           batches: List[dict], lr: float, b1: float, block: int,
           mode: str, w, q=None, fault=None) -> dict:
    """``steps``'s readings of the check: each step's G and D loss, each
    leaf's first gradient norm and its change over all the steps, keyed
    ``gen.<leaf>`` and ``disc.<leaf>``."""
    p0 = {"gen": gen, "disc": disc}
    losses, d_losses, g1, last = [], [], None, None
    for last in steps(gen, disc, hned, vgg, batches, lr, b1, block, mode, w,
                      q, fault):
        losses.append(sum(last["g_terms"]))
        d_losses.append(last["d_loss"])
        if g1 is None:
            g1 = {f"{net}.{k}": float(g.norm())
                  for net, grads in last["grads"].items()
                  for k, g in grads.items()}
    change = {f"{net}.{k}": float((last["params"][net][k].detach()
                                   - v.float()).norm())
              for net, leaves in p0.items() for k, v in leaves.items()}
    return dict(losses=losses, d_losses=d_losses, grad_norms=g1,
                change_norms=change)
