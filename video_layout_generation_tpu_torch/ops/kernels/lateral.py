"""Kernel B: a whole channel-preserving LateralBlock in one launch, NHWC.

``fused_lateral`` launches ``csrc/lateral.cu`` for a CUDA tensor and runs
``fused_lateral_plain`` for a CPU tensor. It is the counterpart of the TPU
kernel ``ops/pallas/conv_packed.py:_fused_lateral_impl``
(fused_lateral_packed3x3) of the JAX package, computed on the logical NHWC
tensor instead of its 2x2 packed form.

Both convs run kernel A's tensor-core inner product; a block computes a
14 x 14 output tile from a 16 x 16 intermediate that lives in shared memory
(1.31x of conv0's work is recomputed on the halo). ``lateral_plan`` holds the
launch geometry in Python, where a CPU test can reach it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ._build import library
from ._checks import (check_cuda, data_ptr, raise_on_error, sm_count,
                      stream_ptr)
from . import conv3x3 as _conv
from .conv3x3 import (CHUNK, PIX_BYTES, SMEM_LIMIT, conv3x3_plain_f32,
                      packed_weights, prelu_plain)

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

    A CPU tensor runs the plain version; a CUDA tensor (bf16) launches the
    kernel, and anything the kernel does not take raises, as does an
    argument that requires grad while autograd is on."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w0, b0, a0, w1, b1, a1, residual)):
        raise NotImplementedError(
            "kernel B has no weight-gradient or data-gradient kernel yet: "
            "it runs forward only")
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


fused_lateral.launches = 0
