"""Non-affine InstanceNorm over H, W of an NHWC tensor, forward and backward.

``instance_norm`` launches ``csrc/instance_norm.cu`` for a CUDA tensor and
runs ``instance_norm_plain`` for a CPU tensor. It is the counterpart of the
TPU kernels of ``ops/pallas/instance_norm.py`` of the JAX package:

- ``_pallas_fwd``: the differentiated forward, which keeps what the backward
  needs. Here ``y`` is ``xhat`` (no affine), so one tensor is written and
  saved, plus ``rstd`` (N, C) f32;
- ``_pallas_fwd_only``: the forward that keeps nothing, taken when no input
  requires grad or autograd is off;
- ``_pallas_bwd``: ``dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat))``.

Mean and biased variance per (n, c) plane, f32 statistics whatever the
input dtype (f32 or bf16), eps 1e-5. Unlike the TPU kernel, which takes
only lane-aligned channel counts and planes that fit on chip, the CUDA
kernel takes any N, H, W, C: no shape-dependent switch to the plain version
exists.

The backward kernel runs through a second ``torch.autograd.Function`` whose
own backward is the closed form in torch ops, so a gradient of a gradient
(the WGAN-GP penalty) works on the card too.

Three counters tell the launches apart: ``instance_norm.launches_fwd``,
``instance_norm.launches_fwd_only`` and ``instance_norm.launches_bwd``.
"""

from __future__ import annotations

import torch

from ._build import library
from ._checks import check_cuda, data_ptr, raise_on_error, stream_ptr

EPS = 1e-5


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype in (torch.float32, torch.float64) \
        else torch.float32


def instance_norm_plain(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain PyTorch version: (x - mean) * rsqrt(var + eps) per (n, c) plane
    of NHWC ``x``, biased variance, statistics in f32 (f64 for an f64
    input), result in ``x``'s dtype."""
    return _forward_plain(x, eps)[0]


def _forward_plain(x: torch.Tensor, eps: float):
    """(y in x's dtype, rstd (N, C) in the statistics' dtype)."""
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=(1, 2), keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xc * rstd).to(x.dtype), rstd[:, 0, 0, :]


def instance_norm_bwd_plain(dy: torch.Tensor, xhat: torch.Tensor,
                            rstd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: dy, xhat (N, H, W, C), rstd
    (N, C) -> dx in dy's dtype, means over H, W in the statistics' dtype."""
    st = _stat_dtype(dy)
    g, xh = dy.to(st), xhat.to(st)
    m_dy = g.mean(dim=(1, 2), keepdim=True)
    m_dyx = (g * xh).mean(dim=(1, 2), keepdim=True)
    dx = rstd.to(st)[:, None, None, :] * (g - m_dy - xh * m_dyx)
    return dx.to(dy.dtype)


def _check_nhwc(x: torch.Tensor, name: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name} must be NHWC, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16 on a CUDA "
                         f"device, got {x.dtype}")


def _scratch(lib, x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    size = lib.vlg_instance_norm_scratch(
        n, h * w, c, int(x.dtype == torch.bfloat16))
    return torch.empty(size, dtype=torch.float32, device=x.device)


def _launch_fwd(x: torch.Tensor, eps: float, keep: bool):
    """Launch the forward on a CUDA tensor. ``keep`` also returns rstd
    (N, C) f32 (else None). Raises on anything the kernel does not take."""
    _check_nhwc(x, "x")
    n, h, w, c = x.shape
    check_cuda(x, x.dtype, (n, h, w, c), "x")
    lib = library("instance_norm")
    y = torch.empty_like(x)
    rstd = (torch.empty((n, c), dtype=torch.float32, device=x.device)
            if keep else None)
    err = lib.vlg_instance_norm_fwd(
        data_ptr(x), data_ptr(y), data_ptr(rstd), data_ptr(_scratch(lib, x)),
        n, h * w, c, float(eps), int(x.dtype == torch.bfloat16),
        stream_ptr(x.device))
    raise_on_error(err, "instance_norm")
    if keep:
        instance_norm.launches_fwd += 1
    else:
        instance_norm.launches_fwd_only += 1
    return y, rstd


def _launch_bwd(dy: torch.Tensor, xhat: torch.Tensor,
                rstd: torch.Tensor) -> torch.Tensor:
    _check_nhwc(dy, "dy")
    n, h, w, c = dy.shape
    check_cuda(dy, dy.dtype, (n, h, w, c), "dy")
    check_cuda(xhat, dy.dtype, (n, h, w, c), "xhat", dy.device)
    check_cuda(rstd, torch.float32, (n, c), "rstd", dy.device)
    lib = library("instance_norm")
    dx = torch.empty_like(dy)
    err = lib.vlg_instance_norm_bwd(
        data_ptr(dy), data_ptr(xhat), data_ptr(rstd), data_ptr(dx),
        data_ptr(_scratch(lib, dy)), n, h * w, c,
        int(dy.dtype == torch.bfloat16), stream_ptr(dy.device))
    raise_on_error(err, "instance_norm backward")
    instance_norm.launches_bwd += 1
    return dx


class _InstanceNormBackward(torch.autograd.Function):
    """dx from (dy, xhat, rstd): the backward kernel (its plain version for
    CPU tensors). Its own backward is autograd of the plain closed form, so
    the first derivative can be differentiated again."""

    @staticmethod
    def forward(ctx, dy, xhat, rstd):
        ctx.save_for_backward(dy, xhat, rstd)
        if dy.device.type == "cpu":
            return instance_norm_bwd_plain(dy, xhat, rstd)
        return _launch_bwd(dy, xhat, rstd)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            out = instance_norm_bwd_plain(*leaves)
            return torch.autograd.grad(out, leaves, grad.to(out.dtype))


class InstanceNormFunction(torch.autograd.Function):
    """(y, rstd) from x. Forward: the kernel that keeps y and rstd. Backward:
    the backward kernel through ``_InstanceNormBackward``. ``rstd`` is an
    output so that a second derivative sees its dependence on x; first-order
    use hands it no gradient."""

    @staticmethod
    def forward(ctx, x, eps):
        if x.device.type == "cpu":
            y, rstd = _forward_plain(x, eps)
        else:
            y, rstd = _launch_fwd(x, eps, keep=True)
        ctx.save_for_backward(y, rstd)
        ctx.set_materialize_grads(False)
        return y, rstd

    @staticmethod
    def backward(ctx, dy, drstd):
        y, rstd = ctx.saved_tensors
        dx = None
        if dy is not None:
            dx = _InstanceNormBackward.apply(dy.contiguous(), y, rstd)
        if drstd is not None:
            # d rstd / d x = -rstd^3 (x - mean) / HW = -rstd^2 xhat / HW
            hw = y.shape[1] * y.shape[2]
            st = rstd.dtype
            extra = (-(drstd.to(st) * rstd * rstd)[:, None, None, :]
                     * y.to(st) / hw).to(y.dtype)
            dx = extra if dx is None else dx + extra
        return dx, None


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Non-affine InstanceNorm of NHWC ``x`` (f32 or bf16) over H and W.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    and anything the kernel does not take (another dtype, a tensor that is
    not contiguous) raises. With autograd on and ``x`` requiring grad the
    forward keeps y and rstd for the backward kernel; otherwise the forward
    keeps nothing."""
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormFunction.apply(x, eps)[0]
    if x.device.type == "cpu":
        return instance_norm_plain(x, eps)
    return _launch_fwd(x, eps, keep=False)[0]


instance_norm.launches_fwd = 0
instance_norm.launches_fwd_only = 0
instance_norm.launches_bwd = 0
