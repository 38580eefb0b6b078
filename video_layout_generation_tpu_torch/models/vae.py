"""Variational layout models: LayoutVAE and the conditional LayoutCVAE (the
JAX package's ``models/vae.py``), on NHWC tensors.

- ``LayoutVAE``: conv encoder over one-hot layouts -> diagonal Gaussian
  latent at 1/8 resolution -> conv decoder -> layout logits.
- ``LayoutCVAE``: the encoder (posterior) sees (context, target), a learned
  prior sees the context alone, and the decoder takes (z, context features)
  with the one-hot context as a full-resolution skip; ``generate`` samples
  the prior, the rollout step.

The JAX package computes every conv of these nets with flax ``nn.Conv`` /
``nn.ConvTranspose`` in XLA, so here they are the library's convs
(``models/layers.py``). Submodules carry flax's names (``posterior``,
``prior``, ``decoder``, ``ctx_proj``, ``encoder``; ``Conv_<i>`` and
``ConvTranspose_<i>`` counted per type in creation order, ``mu``,
``logvar``), so ``io/weights.py:params_from_flax`` carries a flax tree
across unchanged. Parameters stay f32 and are cast to ``dtype`` per call;
``mu`` and ``logvar`` and the logits are f32.

The latent noise comes from an explicit ``torch.Generator`` or is handed in
as ``eps`` (tests pass the JAX package's draws); JAX's threefry streams are
not reproduced.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.one_hot import seg_one_hot
from ..parallel.collectives import draw_rows
from .layers import Conv, ConvTranspose

LOGVAR_BIAS_INIT = -5.0


def latent_hw(h: int, w: int, levels: int = 3) -> Tuple[int, int]:
    """Spatial size after ``levels`` stride-2 3x3 convs with padding 1."""
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class ConvTrunk(nn.Module):
    """Stride-2 3x3 conv + ReLU per width, to 1/8 resolution."""

    def __init__(self, cin: int, widths: Sequence[int] = (32, 64, 64),
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.n_convs = len(widths)
        for i, wdt in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(cin, wdt, 3, stride=2,
                                              padding=1, generator=generator))
            cin = wdt
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.dtype)
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return x


class ConvEncoder(ConvTrunk):
    """The strided trunk, then ``mu`` and ``logvar`` heads, both f32.

    ``logvar``'s bias starts at -5 (std about 0.08): with std about 1 from
    step 0 the decoder learns to ignore z and the posterior collapses."""

    def __init__(self, cin: int, latent_dim: int = 32,
                 widths: Sequence[int] = (32, 64, 128),
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__(cin, widths, dtype, generator)
        c = self.out_channels
        self.mu = Conv(c, latent_dim, 3, padding=1, generator=generator)
        self.logvar = Conv(c, latent_dim, 3, padding=1, generator=generator)
        with torch.no_grad():
            self.logvar.bias.fill_(LOGVAR_BIAS_INIT)

    def forward(self, x: torch.Tensor):
        x = super().forward(x)
        return self.mu(x).float(), self.logvar(x).float()


class ConvDecoder(nn.Module):
    """Per width: a SAME 3x3 stride-2 transposed conv -> ReLU -> ``refines``
    x (3x3 conv -> ReLU); then, with ``skip_channels``, the concatenated
    full-resolution skip through a 3x3 conv -> ReLU; then the head conv to
    ``n_classes`` logits (f32)."""

    def __init__(self, cin: int, n_classes: int = 20,
                 widths: Sequence[int] = (128, 64, 32), refines: int = 1,
                 skip_channels: int = 0,
                 dtype: Optional[torch.dtype] = None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.n_stages, self.refines = len(widths), refines
        n_conv = 0
        for s, wdt in enumerate(widths):
            self.add_module(f"ConvTranspose_{s}", ConvTranspose(
                cin, wdt, 3, stride=2, padding=0, crop=1,
                generator=generator))
            for _ in range(refines):
                self.add_module(f"Conv_{n_conv}", Conv(
                    wdt, wdt, 3, padding=1, generator=generator))
                n_conv += 1
            cin = wdt
        self.skip_conv = None
        if skip_channels:
            self.skip_conv = f"Conv_{n_conv}"
            self.add_module(self.skip_conv, Conv(
                cin + skip_channels, widths[-1], 3, padding=1,
                generator=generator))
            n_conv += 1
            cin = widths[-1]
        self.head = f"Conv_{n_conv}"
        self.add_module(self.head, Conv(cin, n_classes, 3, padding=1,
                                        generator=generator))

    def forward(self, z: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _cast(z, self.dtype)
        n_conv = 0
        for s in range(self.n_stages):
            x = F.relu(getattr(self, f"ConvTranspose_{s}")(x))
            for _ in range(self.refines):
                x = F.relu(getattr(self, f"Conv_{n_conv}")(x))
                n_conv += 1
        if skip is not None:
            if self.skip_conv is None:
                raise ValueError("this decoder was built without a skip")
            s = skip.to(x.dtype) if self.dtype is not None else skip
            x = F.relu(getattr(self, self.skip_conv)(torch.cat([x, s], -1)))
        return getattr(self, self.head)(x).float()


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """mu + exp(logvar / 2) * eps; ``eps`` is drawn from ``generator`` (on
    mu's device) unless it is given: under a process group, this rank's
    rows of the global batch's draw."""
    if eps is None:
        eps = draw_rows(lambda m: torch.randn(
            (m,) + tuple(mu.shape[1:]), generator=generator,
            device=mu.device, dtype=mu.dtype), mu.shape[0])
    return mu + torch.exp(0.5 * logvar) * eps


class LayoutVAE(nn.Module):
    """Single-frame layout autoencoder (one-hot in, logits out)."""

    def __init__(self, n_classes: int = 20, latent_dim: int = 32,
                 widths: Sequence[int] = (32, 64, 128), dec_refines: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.latent_dim = dtype, latent_dim
        self.encoder = ConvEncoder(n_classes, latent_dim, widths, dtype,
                                   generator)
        self.decoder = ConvDecoder(latent_dim, n_classes,
                                   tuple(reversed(tuple(widths))),
                                   dec_refines, dtype=dtype,
                                   generator=generator)

    def forward(self, onehot: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self.encoder(onehot)
        z = reparameterize(mu, logvar, eps, generator)
        return self.decoder(z), mu, logvar

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


class LayoutCVAE(nn.Module):
    """Conditional VAE over layout sequences.

    ``forward(context, target)``: posterior from (context, target), learned
    prior from the context, decode (z from the posterior, context features)
    with the context as skip. ``generate(context)``: sample the prior and
    decode, the rollout step. ``context`` is the channel-stacked one-hot
    stack (N, H, W, context_frames * n_classes)."""

    def __init__(self, n_classes: int = 20, latent_dim: int = 32,
                 context_frames: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.latent_dim = dtype, latent_dim
        self.n_classes, self.context_frames = n_classes, context_frames
        c_ctx = context_frames * n_classes
        self.posterior = ConvEncoder(c_ctx + n_classes, latent_dim,
                                     dtype=dtype, generator=generator)
        self.prior = ConvEncoder(c_ctx, latent_dim, dtype=dtype,
                                 generator=generator)
        self.ctx_proj = ConvTrunk(c_ctx, (32, 64, 64), dtype=dtype,
                                  generator=generator)
        self.decoder = ConvDecoder(latent_dim + self.ctx_proj.out_channels,
                                   n_classes, skip_channels=c_ctx,
                                   dtype=dtype, generator=generator)

    def _decode(self, z: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        feat = self.ctx_proj(context)
        return self.decoder(torch.cat([z.to(feat.dtype), feat], -1),
                            skip=context)

    def forward(self, context: torch.Tensor, target: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu_q, lv_q = self.posterior(torch.cat([context, target], -1))
        mu_p, lv_p = self.prior(context)
        z = reparameterize(mu_q, lv_q, eps, generator)
        return self._decode(z, context), (mu_q, lv_q), (mu_p, lv_p)

    def generate(self, context: torch.Tensor,
                 eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        mu_p, lv_p = self.prior(context)
        return self._decode(reparameterize(mu_p, lv_p, eps, generator),
                            context)


def one_hot_context(c1: torch.Tensor, c2: torch.Tensor, n_classes: int
                    ) -> torch.Tensor:
    """Two (N, H, W) id maps -> the channel-stacked f32 one-hot context."""
    return torch.cat([seg_one_hot(c1, n_classes),
                      seg_one_hot(c2, n_classes)], -1)


def make_cvae_rollout(model: LayoutCVAE, n_frames: int = 16,
                      n_classes: int = 20):
    """Autoregressive layout rollout: slide a 2-layout one-hot context,
    sample the prior, take the argmax and feed it back, ``n_frames`` times
    (a Python loop under ``torch.inference_mode``).

    ``rollout(seg1, seg2, generator=None, eps=None)``: (N, H, W) int ids on
    the model's device -> (N, n_frames, H, W) int64 ids. Each frame's prior
    noise is drawn from ``generator``, or taken from ``eps`` (a sequence of
    ``n_frames`` tensors of the latent's shape)."""

    @torch.inference_mode()
    def rollout(seg1: torch.Tensor, seg2: torch.Tensor,
                generator: Optional[torch.Generator] = None, eps=None):
        c1, c2 = seg1.long(), seg2.long()
        segs = []
        for t in range(n_frames):
            logits = model.generate(one_hot_context(c1, c2, n_classes),
                                    None if eps is None else eps[t],
                                    generator)
            c1, c2 = c2, logits.argmax(-1)
            segs.append(c2)
        return torch.stack(segs, 1)

    return rollout
