"""Kernel A: fused PReLU -> 3x3 conv -> bias (-> + residual) (-> ReLU), NHWC.

``prelu_conv3x3`` launches ``csrc/conv3x3.cu`` for a CUDA tensor and runs
``prelu_conv3x3_plain`` for a CPU tensor. It is the counterpart of the TPU
kernels ``ops/pallas/conv_packed.py:_fused_impl`` (conv_packed3x3_sparse,
prelu_conv_packed3x3, prelu_conv_packed3x3_res),
``ops/pallas/conv1x2.py:_fwd_impl`` (conv3x3_w1x2) and
``ops/pallas/conv3x3.py:_conv3x3_fwd_impl`` (conv3x3_pallas) of the JAX
package, computed on the logical NHWC tensor instead of their packed forms.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._build import library
from ._checks import check_cuda, data_ptr, raise_on_error, stream_ptr


def prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Scalar-alpha PReLU of ``x`` in f32, the slope and the product rounded
    to ``x``'s dtype as the kernels do."""
    xf = x.float()
    a = alpha.reshape(()).to(x.dtype).float()
    return torch.where(xf >= 0, xf, (a * xf).to(x.dtype).float())


def conv3x3_plain_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """f32 3x3 conv with zero padding 1 of an NHWC tensor, HWIO weights."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), b.float(), stride=stride,
                 padding=1)
    return y.permute(0, 2, 3, 1)


def prelu_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        alpha: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        stride: int = 1, relu_out: bool = False
                        ) -> torch.Tensor:
    """Plain PyTorch version of kernel A, in f32 math, rounded to ``x``'s
    dtype once at the end."""
    xf = x.float() if alpha is None else prelu_plain(x, alpha)
    y = conv3x3_plain_f32(xf, w, b, stride)
    if residual is not None:
        y = y + residual.float()
    if relu_out:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).contiguous()


def prelu_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  alpha: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  stride: int = 1, relu_out: bool = False) -> torch.Tensor:
    """y = conv3x3(prelu(x, alpha)) + b [+ residual], zero padding 1;
    ``relu_out`` clamps y at zero (the conv -> ReLU layers of VGG19 and
    HNED).

    x (N, H, W, Ci); w (3, 3, Ci, Co) HWIO in x's dtype; b (Co,) f32;
    alpha a one-element f32 tensor or None (no PReLU); residual shaped like
    the output or None; stride 1 or 2. The output has x's dtype.

    A CPU tensor runs the plain version; a CUDA tensor (bf16) launches the
    kernel, and anything the kernel does not take raises."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.device.type == "cpu":
        return prelu_conv3x3_plain(x, w, b, alpha, residual, stride,
                                   relu_out)
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    check_cuda(x, torch.bfloat16, (n, h, wd, ci), "x")
    check_cuda(w, torch.bfloat16, (3, 3, ci, co), "w", x.device)
    check_cuda(b, torch.float32, (co,), "b", x.device)
    if alpha is not None:
        check_cuda(alpha, torch.float32, tuple(alpha.shape), "alpha",
                   x.device)
        if alpha.numel() != 1:
            raise ValueError("alpha must hold one value")
    if residual is not None:
        check_cuda(residual, torch.bfloat16, (n, ho, wo, co), "residual",
                   x.device)
    lib = library("conv3x3")
    smem = lib.vlg_prelu_conv3x3_smem(ci, stride)
    if smem > 227 * 1024:
        raise ValueError(f"Ci={ci} at stride {stride} needs {smem} bytes "
                         f"of shared memory per block; the card has 227 KB")
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    err = lib.vlg_prelu_conv3x3(
        data_ptr(x), data_ptr(w), data_ptr(b), data_ptr(alpha),
        data_ptr(residual), data_ptr(out), n, h, wd, ci, co, stride,
        int(relu_out), stream_ptr(x.device))
    raise_on_error(err, "prelu_conv3x3")
    prelu_conv3x3.launches += 1
    return out


prelu_conv3x3.launches = 0
