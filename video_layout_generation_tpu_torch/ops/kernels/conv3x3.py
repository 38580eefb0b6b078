"""Kernel A: fused PReLU -> 3x3 conv -> bias (-> + residual) (-> ReLU), NHWC.

``prelu_conv3x3`` launches ``csrc/conv3x3.cu`` for a CUDA tensor and runs
``prelu_conv3x3_plain`` for a CPU tensor. It is the counterpart of the TPU
kernels ``ops/pallas/conv_packed.py:_fused_impl`` (conv_packed3x3_sparse,
prelu_conv_packed3x3, prelu_conv_packed3x3_res),
``ops/pallas/conv1x2.py:_fwd_impl`` (conv3x3_w1x2) and
``ops/pallas/conv3x3.py:_conv3x3_fwd_impl`` (conv3x3_pallas) of the JAX
package, computed on the logical NHWC tensor instead of their packed forms.

Gradients: the data gradient of the stride-1 conv without PReLU and
residual (the conv -> ReLU layers of the frozen VGG19 trunk, through which
the perceptual loss is differentiated) is itself a launch of kernel A:
``dx = conv3x3(dz, W')`` with ``dz = dy * (y > 0)`` under ``relu_out`` and
``W'[kh, kw, co, ci] = W[2 - kh, 2 - kw, ci, co]``. Nothing else has a
backward kernel yet: a weight, bias, slope or residual that requires grad,
or a data gradient through PReLU or stride 2, raises.
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


def _no_backward(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"kernel A has no {what} kernel yet: it differentiates only the "
        f"stride-1 conv without PReLU and residual with respect to its "
        f"input, with frozen weights")


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
    kernel, and anything the kernel does not take raises. With autograd on,
    an ``x`` that requires grad gets its gradient from a second launch of
    the kernel (see the module's docstring); any other gradient raises
    ``NotImplementedError`` on either device."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if torch.is_grad_enabled():
        if any(t is not None and t.requires_grad for t in (w, b, alpha)):
            raise _no_backward("weight-gradient")
        if residual is not None and residual.requires_grad:
            raise _no_backward("residual-gradient")
        if x.requires_grad:
            if alpha is not None or residual is not None or stride != 1:
                raise _no_backward("PReLU, residual or stride-2 "
                                   "data-gradient")
            return _Conv3x3DataGrad.apply(x, w, b, relu_out)
    return _forward(x, w, b, alpha, residual, stride, relu_out)


def _forward(x, w, b, alpha, residual, stride, relu_out) -> torch.Tensor:
    """The plain version for a CPU tensor, one launch for a CUDA tensor."""
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


class _Conv3x3DataGrad(torch.autograd.Function):
    """y = conv3x3(x, w) + b (-> ReLU) with frozen w and b. Backward: the
    same conv of the masked output gradient with the kernel flipped in
    space and its channel axes swapped, no bias: one more launch of kernel
    A (its plain version for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, b, relu_out):
        y = _forward(x, w, b, None, None, 1, relu_out)
        ctx.relu_out = relu_out
        ctx.save_for_backward(w, y if relu_out else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        w, y = ctx.saved_tensors
        dz = dy * (y > 0) if ctx.relu_out else dy
        wt = w.flip(0, 1).transpose(2, 3).contiguous()
        zero = torch.zeros(w.shape[2], dtype=torch.float32, device=w.device)
        dx = _forward(dz.contiguous(), wt, zero, None, None, 1, False)
        return dx, None, None, None


prelu_conv3x3.launches = 0
