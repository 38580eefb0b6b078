"""Kernel A: fused PReLU -> 3x3 conv -> bias (-> + residual) (-> ReLU), NHWC.

``prelu_conv3x3`` launches ``csrc/conv3x3.cu`` for a CUDA tensor and runs
``prelu_conv3x3_plain`` for a CPU tensor or under ``plain()``. It is the
counterpart of the TPU kernels ``ops/pallas/conv_packed.py:_fused_impl``
(conv_packed3x3_sparse, prelu_conv_packed3x3, prelu_conv_packed3x3_res),
``ops/pallas/conv1x2.py:_fwd_impl`` (conv3x3_w1x2) and
``ops/pallas/conv3x3.py:_conv3x3_fwd_impl`` (conv3x3_pallas) of the JAX
package, computed on the logical NHWC tensor instead of their packed forms.

The kernel is an implicit GEMM on the tensor cores (``csrc/conv_common.cuh``).
What it needs from the host is decided here, in Python, so that the CPU tests
can hold it: ``conv_plan`` picks the block of output channels, the number of
ring stages and the shared memory for a shape, and ``packed_weights`` hands
the kernel weight rows that start on 16 bytes (Co padded to a multiple of 8)
and, for the data gradient, the flipped and transposed kernel, both from a
cache keyed on the weight tensor and its version.

Gradients: the data gradient of the stride-1 conv without PReLU and
residual, when only ``x`` requires grad (the conv -> ReLU layers of the
frozen VGG19 trunk, through which the perceptual loss is differentiated), is
itself a launch of kernel A: ``dx = conv3x3(dz, W')`` with ``dz = dy * (y >
0)`` under ``relu_out`` and ``W'[kh, kw, co, ci] = W[2 - kh, 2 - kw, ci,
co]``. Every other gradient (x through PReLU or stride 2, W, b, alpha, the
residual: GridNet's training) is the library's VJP of the same function,
recomputed from the saved inputs as the JAX package's ``custom_vjp``s
recompute the XLA conv (``ops/pallas/conv_packed.py:_pc_bwd``,
``_pcr_bwd``): ``conv3x3_vjp`` through ``aten.convolution_backward`` (cuDNN
on the card) in the activation dtype on the channels_last views of the
NHWC tensors, the PReLU's derivative elementwise, the bias and slope
gradients summed in f32. It launches no kernel of the port.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from . import _checks
from ._build import library
from ._checks import (check_cuda, data_ptr, raise_on_error, sm_count,
                      stream_ptr)


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


# The kernel's fixed geometry (csrc/conv3x3.cu, csrc/conv_common.cuh).
TILE_W = 16                 # output columns of a block: one m16 tile a row
TILE_ROWS = (8, 16)         # output rows of a block: 2 or 4 a warp
CHUNK = 16                  # input channels per ring stage
PIX_BYTES = (CHUNK + 8) * 2  # a staged pixel: 32 bytes and 16 of padding
MAX_STAGES = 3
# two blocks an SM: 228 KB less 1 KB reserved for each
SMEM_LIMIT = 113 * 1024
SMEM_PER_SM = 228 * 1024
N_SM = 132                  # an H100; the wrapper passes the card's own
MAX_BLOCKS_PER_SM = 3       # the kernel's launch bounds: registers


def scratch_bytes(bn: int) -> int:
    """The epilogue's warp-private f32 scratch: four warps, one m-tile of 16
    pixels each, rows padded by 8 floats."""
    return 4 * 16 * (bn + 8) * 4


def stage_bytes(bn: int, stride: int, tile_h: int = 8) -> int:
    """Shared memory of one ring stage: the input tile with its halo and
    the weights of the nine taps, ``CHUNK`` input channels of each."""
    rows, cols = (tile_h - 1) * stride + 3, (TILE_W - 1) * stride + 3
    return rows * cols * PIX_BYTES + 9 * CHUNK * (bn + 8) * 2


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, ci: int, co: int, stride: int = 1,
              n_sm: int = N_SM) -> dict:
    """How kernel A runs a conv of an (n, h, w, ci) input to ``co`` channels:
    ``tile`` output pixels and ``bn`` output channels (32 or 64) an item,
    ``stages`` of the ring, ``smem`` bytes a block, the ``grid`` of items
    (pixel tiles, channel blocks), the persistent ``blocks`` that share them
    and ``chunks`` of input channels. Shared memory does not depend on ci.
    The dict is kept per shape: read it, do not change it."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if min(n, h, w, ci, co) < 1:
        raise ValueError(f"empty conv: {(n, h, w, ci, co)}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1

    def tiles(tile_h):
        return n * (-(-ho // tile_h)) * (-(-wo // TILE_W))

    tile_h = TILE_ROWS[0]
    bn = 32 if co <= 32 else 64
    if bn == 64 and tiles(tile_h) * (-(-co // 64)) < n_sm:
        bn = 32     # a small image: more, narrower items fill the card
    elif stride == 1 and tiles(TILE_ROWS[1]) * (-(-co // bn)) >= 2 * n_sm:
        # enough work to fill the card with 16 x 16 tiles: half the ldmatrix
        # traffic per mma, and half as many items to set up and store
        tile_h = TILE_ROWS[1]
    fixed = scratch_bytes(bn)
    stage = stage_bytes(bn, stride, tile_h)
    # three blocks an SM where the registers allow it (bn = 32): more warps
    # hide more latency than a third stage does
    limit = SMEM_PER_SM // 3 - 1024 if bn == 32 else SMEM_LIMIT
    stages = MAX_STAGES
    while stages > 2 and fixed + stages * stage > limit:
        stages -= 1
    smem = fixed + stages * stage
    grid = (tiles(tile_h), -(-co // bn))
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    return dict(tile=(tile_h, TILE_W), bn=bn, stages=stages, smem=smem,
                grid=grid, blocks=min(grid[0] * grid[1], n_sm * per_sm),
                chunks=-(-ci // CHUNK))


def pack_weights(w: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """The HWIO kernel as the CUDA kernels read it: output channels padded
    with zeros to a multiple of 8, contiguous. With ``transposed`` the
    kernel of the data gradient, W'[kh, kw, co, ci] = W[2 - kh, 2 - kw, ci,
    co], packed the same way."""
    if transposed:
        w = w.flip(0, 1).transpose(2, 3)
    pad = -w.shape[-1] % 8
    if pad:
        w = F.pad(w, (0, pad))
    return w.contiguous()


_PACKS: dict = {}   # (id(w), transposed) -> (weakref to w, version, packed)


def packed_weights(w: torch.Tensor, transposed: bool = False
                   ) -> torch.Tensor:
    """``pack_weights`` through a cache keyed on the tensor and its version
    counter: a parameter updated in place is packed again, and an entry
    goes when its tensor does. A kernel that needs no packing is returned
    as it is; an inference tensor has no version counter and is packed on
    every call."""
    if not transposed and w.shape[-1] % 8 == 0 and w.is_contiguous():
        return w
    if w.is_inference():
        return pack_weights(w, transposed)
    key = (id(w), transposed)
    hit = _PACKS.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    packed = pack_weights(w.detach(), transposed)
    _PACKS[key] = (weakref.ref(w, lambda _, key=key: _PACKS.pop(key, None)),
                   w._version, packed)
    return packed


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

    A CPU tensor, or any tensor under ``plain()``, runs the plain version
    (under ``plain()`` in ordinary autograd); a CUDA tensor (bf16) launches
    the kernel, and anything the kernel does not take raises. With autograd
    on, an argument that requires grad gets its gradient from a second
    launch of the kernel (only x, stride 1, no PReLU, no residual) or else
    from the library's VJP (see the module's docstring)."""
    if _checks.PLAIN:
        return prelu_conv3x3_plain(x, w, b, alpha, residual, stride,
                                   relu_out)
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if torch.is_grad_enabled():
        needs = [t is not None and t.requires_grad
                 for t in (x, w, b, alpha, residual)]
        if needs == [True, False, False, False, False] and stride == 1 \
                and alpha is None and residual is None:
            return _Conv3x3DataGrad.apply(x, w, b, relu_out)
        if any(needs):
            return _PreluConv3x3.apply(x, w, b, alpha, residual, stride,
                                       relu_out)
    return _forward(x, w, b, alpha, residual, stride, relu_out)


def _forward(x, w, b, alpha, residual, stride, relu_out,
             transposed: bool = False) -> torch.Tensor:
    """The plain version for a CPU tensor, one launch for a CUDA tensor.
    With ``transposed`` the conv runs on the flipped, transposed kernel
    (``pack_weights``): the data gradient."""
    if x.device.type == "cpu":
        if transposed:
            w = pack_weights(w, True)[..., :w.shape[2]]
        return prelu_conv3x3_plain(x, w, b, alpha, residual, stride,
                                   relu_out)
    n, h, wd, ci = x.shape
    co = w.shape[2] if transposed else w.shape[3]
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    check_cuda(x, torch.bfloat16, (n, h, wd, ci), "x")
    check_cuda(w, torch.bfloat16,
               (3, 3, co, ci) if transposed else (3, 3, ci, co), "w",
               x.device)
    check_cuda(b, torch.float32, (co,), "b", x.device)
    if alpha is not None:
        check_cuda(alpha, torch.float32, tuple(alpha.shape), "alpha",
                   x.device)
        if alpha.numel() != 1:
            raise ValueError("alpha must hold one value")
    if residual is not None:
        check_cuda(residual, torch.bfloat16, (n, ho, wo, co), "residual",
                   x.device)
    plan = conv_plan(n, h, wd, ci, co, stride, sm_count(x.device))
    wp = packed_weights(w, transposed)
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    err = library("conv3x3").vlg_prelu_conv3x3(
        data_ptr(x), data_ptr(wp), data_ptr(b), data_ptr(alpha),
        data_ptr(residual), data_ptr(out), n, h, wd, ci, co, wp.shape[-1],
        stride, int(relu_out), plan["tile"][0], plan["bn"], plan["stages"],
        plan["smem"], plan["blocks"], stream_ptr(x.device))
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
        zero = torch.zeros(w.shape[2], dtype=torch.float32, device=w.device)
        dx = _forward(dz.contiguous(), w, zero, None, None, 1, False,
                      transposed=True)
        return dx, None, None, None


# ---- the library's VJP (every gradient but _Conv3x3DataGrad's) -------------

def nchw_view(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the NCHW view the library reads as channels_last
    (no copy)."""
    return t.permute(0, 3, 1, 2)


def conv3x3_vjp(xa: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                stride: int, need_x: bool = True, need_w: bool = True):
    """(dxa, dw) of y = conv3x3(xa, w), zero padding 1, no bias: NHWC
    activations, HWIO kernel, computed by ``aten.convolution_backward`` in
    xa's dtype (cuDNN on the card; it knows the stride-2 conv's output
    padding from xa's shape). An entry not asked for is None."""
    dxa, dw, _ = torch.ops.aten.convolution_backward(
        nchw_view(dy), nchw_view(xa), w.permute(3, 2, 0, 1), None,
        [stride, stride], [1, 1], [1, 1], False, [0, 0], 1,
        [need_x, need_w, False])
    return (None if dxa is None else dxa.permute(0, 2, 3, 1),
            None if dw is None else dw.permute(2, 3, 1, 0))


def prelu_vjp(x: torch.Tensor, alpha: torch.Tensor, dxa: torch.Tensor,
              need_x: bool = True, need_alpha: bool = True):
    """(dx, dalpha) of xa = prelu(x, alpha) with the slope rounded to x's
    dtype (``prelu_plain``), the kernels' and the JAX package's convention
    at x == 0 (the identity's side: dx = dxa there, where the library's
    PReLU backward takes the slope's). dx in x's dtype; dalpha, the sum of
    min(x, 0) * dxa over the whole tensor, accumulated in f32 and shaped
    like alpha. An entry not asked for is None."""
    dx = da = None
    if need_x:
        dx = torch.where(x < 0, dxa * alpha.reshape(()).to(x.dtype), dxa)
    if need_alpha:
        da = (x.clamp(max=0) * dxa).sum(dtype=torch.float32)
        da = da.reshape(alpha.shape)
    return dx, da


def bias_vjp(dy: torch.Tensor) -> torch.Tensor:
    """db of y = ... + b: dy summed over N, H, W in f32."""
    return dy.sum(dim=(0, 1, 2), dtype=torch.float32)


def prelu_in_dtype(x: torch.Tensor, alpha: Optional[torch.Tensor]):
    """prelu(x, alpha) in x's dtype, the slope rounded to it (x itself when
    alpha is None), for the backward's recomputation: one library
    kernel."""
    if alpha is None:
        return x
    return F.prelu(x, alpha.reshape(1).to(x.dtype))


class _PreluConv3x3(torch.autograd.Function):
    """Kernel A with every gradient: the forward is one launch (the plain
    version on the CPU); the backward recomputes prelu(x) from the saved x
    and takes the library's VJP (``conv3x3_vjp``, ``prelu_vjp``,
    ``bias_vjp``), launching nothing of the port."""

    @staticmethod
    def forward(ctx, x, w, b, alpha, residual, stride, relu_out):
        y = _forward(x, w, b, alpha, residual, stride, relu_out)
        ctx.stride, ctx.relu_out = stride, relu_out
        ctx.save_for_backward(x, w, alpha, y if relu_out else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, alpha, y = ctx.saved_tensors
        nx, nw, nb, na, nr = ctx.needs_input_grad[:5]
        if ctx.relu_out:
            dy = dy * (y > 0)
        dx = dw = db = da = dr = None
        if nx or nw or na:
            xa = prelu_in_dtype(x, alpha)
            dxa, dw = conv3x3_vjp(xa, w, dy, ctx.stride, nx or na, nw)
            if alpha is None:
                dx = dxa
            elif nx or na:
                dx, da = prelu_vjp(x, alpha, dxa, nx, na)
        if nb:
            db = bias_vjp(dy)
        if nr:
            dr = dy
        return dx, dw, db, da, dr, None, None


prelu_conv3x3.launches = 0
