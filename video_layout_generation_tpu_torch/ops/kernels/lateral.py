"""Kernel B: a whole channel-preserving LateralBlock in one launch, NHWC.

``fused_lateral`` launches ``csrc/lateral.cu`` for a CUDA tensor and runs
``fused_lateral_plain`` for a CPU tensor. It is the counterpart of the TPU
kernel ``ops/pallas/conv_packed.py:_fused_lateral_impl``
(fused_lateral_packed3x3) of the JAX package, computed on the logical NHWC
tensor instead of its 2x2 packed form.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import library
from ._checks import check_cuda, data_ptr, raise_on_error, stream_ptr
from .conv3x3 import conv3x3_plain_f32, prelu_plain


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
    lib = library("lateral")
    smem = lib.vlg_fused_lateral_smem(c)
    if smem > 227 * 1024:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory per "
                         f"block; the card has 227 KB")
    out = torch.empty_like(x)
    err = lib.vlg_fused_lateral(
        data_ptr(x), data_ptr(w0), data_ptr(b0), data_ptr(a0), data_ptr(w1),
        data_ptr(b1), data_ptr(a1), data_ptr(residual), data_ptr(out),
        n, h, wd, c, stream_ptr(x.device))
    raise_on_error(err, "fused_lateral")
    fused_lateral.launches += 1
    return out


fused_lateral.launches = 0
