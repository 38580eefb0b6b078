"""Kernel B: a whole channel-preserving LateralBlock in one launch, NHWC.

``fused_lateral`` launches ``csrc/lateral.cu`` for a CUDA tensor and runs
``fused_lateral_plain`` for a CPU tensor or under ``plain()``. It is the
counterpart of the TPU kernel
``ops/pallas/conv_packed.py:_fused_lateral_impl`` (fused_lateral_packed3x3)
of the JAX package, computed on the logical NHWC tensor instead of its 2x2
packed form.

Both convs run kernel A's tensor-core inner product; a block computes a
14 x 14 output tile from a 16 x 16 intermediate that lives in shared memory
(1.31x of conv0's work is recomputed on the halo). ``lateral_plan`` holds the
launch geometry in Python, where a CPU test can reach it.

Gradients: with autograd on and any argument requiring grad, the call is
``_FusedLateral``: the same launch forward, and as backward the library's
VJP of the same function, recomputed from the saved x as the JAX package's
``ops/pallas/conv_packed.py:_fl_bwd`` recomputes ``_lateral_ref_xla``:
conv0 again through the library, its output rounded to x's dtype before
PReLU1 as the kernel rounds it, then kernel A's ``conv3x3_vjp``,
``prelu_vjp`` and ``bias_vjp`` for both convs (cuDNN in the activation dtype
on the card, slope and bias gradients summed in f32). It launches no kernel
of the port.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _checks
from ._build import library
from ._checks import (check_cuda, data_ptr, raise_on_error, sm_count,
                      stream_ptr)
from . import conv3x3 as _conv
from .conv3x3 import (CHUNK, PIX_BYTES, SMEM_LIMIT, bias_vjp,
                      conv3x3_plain_f32, conv3x3_vjp, nchw_view,
                      packed_weights, prelu_in_dtype, prelu_plain, prelu_vjp)

# The kernel's fixed geometry (csrc/lateral.cu).
TILE = 14                   # output pixels of a block, square
MID = TILE + 2              # the intermediate: one m16 tile a row
BN = 32                     # output channels a pass
RECOMPUTE = MID * MID / (TILE * TILE)   # conv0's work over the ideal
MAX_BLOCKS_PER_SM = 2       # the kernel's launch bounds: about 210 registers


@functools.lru_cache(maxsize=None)
def lateral_plan(n: int, h: int, w: int, c: int,
                 n_sm: int = _conv.N_SM) -> dict:
    """How kernel B runs a LateralBlock on an (n, h, w, c) tensor: ``smem``
    bytes a block (the bf16 intermediate of MID x MID pixels, channels
    padded to the chunk, and ``stages`` ring stages of the 18 x 18 input
    tile and one weight chunk), the ``grid`` of tiles, the persistent
    ``blocks`` that share them and the ring ``steps`` of a tile. The dict is
    kept per shape: read it, do not change it."""
    if min(n, h, w, c) < 1:
        raise ValueError(f"empty block: {(n, h, w, c)}")
    chunks = -(-c // CHUNK)
    mid = MID * MID * (chunks * CHUNK + 8) * 2
    stage = (TILE + 4) ** 2 * PIX_BYTES + 9 * CHUNK * (BN + 8) * 2
    stages = _conv.MAX_STAGES
    while stages > 2 and mid + stages * stage > SMEM_LIMIT:
        stages -= 1
    smem = mid + stages * stage
    tiles = n * (-(-h // TILE)) * (-(-w // TILE))
    per_sm = max(1, min(MAX_BLOCKS_PER_SM,
                        _conv.SMEM_PER_SM // (smem + 1024)))
    return dict(tile=(TILE, TILE), bn=BN, stages=stages, smem=smem,
                grid=(tiles, 1), blocks=min(tiles, n_sm * per_sm),
                steps=2 * chunks * (-(-c // BN)))


def fused_lateral_plain(x, w0, b0, a0, w1, b1, a1,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of kernel B in f32 math: the intermediate is
    rounded to ``x``'s dtype before PReLU1, as the kernel does."""
    y = conv3x3_plain_f32(prelu_plain(x, a0), w0, b0).to(x.dtype)
    y = conv3x3_plain_f32(prelu_plain(y, a1), w1, b1)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype).contiguous()


def fused_lateral(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                  a0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  a1: torch.Tensor, residual: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """out = conv1(prelu1(conv0(prelu0(x)))) [+ residual].

    x (N, H, W, C); w0, w1 (3, 3, C, C) HWIO in x's dtype; b0, b1 (C,) f32;
    a0, a1 one-element f32 tensors; residual like x or None.

    A CPU tensor, or any tensor under ``plain()``, runs the plain version
    (under ``plain()`` in ordinary autograd); a CUDA tensor (bf16) launches
    the kernel, and anything the kernel does not take raises. With autograd
    on, an argument that requires grad gets its gradient from the library's
    VJP (see the module's docstring)."""
    if _checks.PLAIN:
        return fused_lateral_plain(x, w0, b0, a0, w1, b1, a1, residual)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w0, b0, a0, w1, b1, a1, residual)):
        return _FusedLateral.apply(x, w0, b0, a0, w1, b1, a1, residual)
    return _forward(x, w0, b0, a0, w1, b1, a1, residual)


def _forward(x, w0, b0, a0, w1, b1, a1, residual) -> torch.Tensor:
    """The plain version for a CPU tensor, one launch for a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_lateral_plain(x, w0, b0, a0, w1, b1, a1, residual)
    n, h, wd, c = x.shape
    check_cuda(x, torch.bfloat16, (n, h, wd, c), "x")
    for name, wt in (("w0", w0), ("w1", w1)):
        check_cuda(wt, torch.bfloat16, (3, 3, c, c), name, x.device)
    for name, bt in (("b0", b0), ("b1", b1)):
        check_cuda(bt, torch.float32, (c,), name, x.device)
    for name, at in (("a0", a0), ("a1", a1)):
        check_cuda(at, torch.float32, tuple(at.shape), name, x.device)
        if at.numel() != 1:
            raise ValueError(f"{name} must hold one value")
    if residual is not None:
        check_cuda(residual, torch.bfloat16, (n, h, wd, c), "residual",
                   x.device)
    plan = lateral_plan(n, h, wd, c, sm_count(x.device))
    if plan["smem"] > 227 * 1024:
        raise ValueError(f"C={c} needs {plan['smem']} bytes of shared "
                         f"memory per block for the intermediate; the card "
                         f"has 227 KB")
    w0p, w1p = packed_weights(w0), packed_weights(w1)
    out = torch.empty_like(x)
    err = library("lateral").vlg_fused_lateral(
        data_ptr(x), data_ptr(w0p), data_ptr(b0), data_ptr(a0),
        data_ptr(w1p), data_ptr(b1), data_ptr(a1), data_ptr(residual),
        data_ptr(out), n, h, wd, c, w0p.shape[-1], plan["stages"],
        plan["smem"], plan["blocks"], stream_ptr(x.device))
    raise_on_error(err, "fused_lateral")
    fused_lateral.launches += 1
    return out


def _conv0(x, w0, b0, a0):
    """(prelu0(x), the intermediate conv0(prelu0(x)) + b0 in x's dtype),
    through the library, for the backward. The conv's output is rounded
    to x's dtype before the f32 bias is added (and the sum rounded), where
    the kernel rounds once: an intermediate within rounding of zero can
    take the other side of PReLU1 here."""
    xa0 = prelu_in_dtype(x, a0)
    y0 = torch.nn.functional.conv2d(nchw_view(xa0), w0.permute(3, 2, 0, 1),
                                    padding=1).permute(0, 2, 3, 1)
    return xa0, y0.add_(b0)


class _FusedLateral(torch.autograd.Function):
    """Kernel B with every gradient: the forward is one launch (the plain
    version on the CPU); the backward recomputes the intermediate from the
    saved x through the library and takes the library's VJP of both convs,
    launching nothing of the port."""

    @staticmethod
    def forward(ctx, x, w0, b0, a0, w1, b1, a1, residual):
        ctx.save_for_backward(x, w0, b0, a0, w1, a1)
        return _forward(x, w0, b0, a0, w1, b1, a1, residual)

    @staticmethod
    def backward(ctx, dy):
        x, w0, b0, a0, w1, a1 = ctx.saved_tensors
        nx, nw0, nb0, na0, nw1, nb1, na1, nr = ctx.needs_input_grad
        xa0, y0 = _conv0(x, w0, b0, a0)
        xa1 = prelu_in_dtype(y0, a1)
        db1 = bias_vjp(dy) if nb1 else None
        dr = dy if nr else None
        front = nx or nw0 or nb0 or na0
        dxa1, dw1 = conv3x3_vjp(xa1, w1, dy, 1, front or na1, nw1)
        dy0 = da1 = dx = dw0 = db0 = da0 = None
        if front or na1:
            dy0, da1 = prelu_vjp(y0, a1, dxa1, front, na1)
        if front:
            db0 = bias_vjp(dy0) if nb0 else None
            dxa0, dw0 = conv3x3_vjp(xa0, w0, dy0, 1, nx or na0, nw0)
            if nx or na0:
                dx, da0 = prelu_vjp(x, a0, dxa0, nx, na0)
        return dx, dw0, db0, da0, dw1, db1, da1, dr


fused_lateral.launches = 0
