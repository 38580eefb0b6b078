"""Resizes of NHWC tensors (the JAX package's ``ops/resize.py``).

``upsample2x_bilinear_align`` is torch ``nn.Upsample(scale_factor=2,
mode="bilinear", align_corners=True)`` (the reference's up blocks), the
function the JAX package computes in ``ops/resize.py`` as a banded stencil.
On a CUDA tensor that needs a gradient its backward is the adjoint as two
matmuls with the interpolation matrices, in f32: the library's backward
scatters with atomic adds, whose order, and so whose bits, change from run
to run, and training on the card is then not reproducible.
``upsample2x_nearest`` repeats every pixel 2x2, the rollout's opt-in
``upsample="nearest"``.

``resize_bilinear`` is the general separable bilinear resize, up or down,
in both coordinate conventions, computed as the JAX package computes it:
``A_h @ x @ A_w^T`` with row-stochastic interpolation matrices, in f32.
``align_corners=False`` is torch ``F.interpolate(mode="bilinear")`` (HNED's
score maps, ``edge_scale``), ``align_corners=True`` torch ``nn.Upsample``.
``resize_nearest`` is floor-nearest (cv2 ``INTER_NEAREST``), a gather, so
exact for every dtype; ``interp_matrix`` is the (out, in) matrix of either
method.

Left out, as TPU adapters of the JAX package: ``upsample2x_phases``,
``upsample2x_bilinear_align_stencil`` and ``upsample2x_align_to_1x2`` (the
banded and 1x2-packed forms of the 2x upsample).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _upsample2x_align(x: torch.Tensor) -> torch.Tensor:
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


class _DeterministicUpsample(torch.autograd.Function):
    """``_upsample2x_align`` with the adjoint of its interpolation matrices
    as its backward: dx = A_h^T dy A_w, two f32 matmuls, the same bits on
    every run."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = (x.shape[1], x.shape[2])
        return _upsample2x_align(x)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.hw
        ah = _interp_matrix(h, 2 * h, "bilinear", True, dy.device)
        aw = _interp_matrix(w, 2 * w, "bilinear", True, dy.device)
        t = torch.einsum("ph,npqc->nhqc", ah, dy.float())
        return torch.einsum("qw,nhqc->nhwc", aw, t).to(dy.dtype)


def upsample2x_bilinear_align(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        return _DeterministicUpsample.apply(x)
    return _upsample2x_align(x)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample2x(x: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    if mode == "bilinear":
        return upsample2x_bilinear_align(x)
    if mode == "nearest":
        return upsample2x_nearest(x)
    raise ValueError(f"upsample must be 'bilinear' or 'nearest', got {mode!r}")


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int, method: str,
                      align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if method == "nearest":
        # cv2 INTER_NEAREST / torch 'nearest': src = floor(dst * in/out)
        A[np.arange(out_size), _nearest_src(in_size, out_size)] = 1.0
        return A
    if method != "bilinear":
        raise ValueError(f"unknown resize method {method!r}")
    if in_size == 1:
        A[:, 0] = 1.0
        return A
    if align_corners:
        if out_size == 1:
            A[0, 0] = 1.0
            return A
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    A[np.arange(out_size), lo] += 1.0 - frac
    A[np.arange(out_size), hi] += frac
    return A


def _nearest_src(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output index under floor-nearest."""
    return np.minimum((np.arange(out_size) * (in_size / out_size))
                      .astype(np.int64), in_size - 1)


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, method: str,
                   align_corners: bool, device: torch.device
                   ) -> torch.Tensor:
    # made once per device: an upload inside the rollout loop would wait
    # for the device on every frame
    return torch.from_numpy(_interp_matrix_np(
        in_size, out_size, method, align_corners)).to(device)


def interp_matrix(in_size: int, out_size: int, method: str = "bilinear",
                  align_corners: bool = False) -> torch.Tensor:
    """The (out_size, in_size) f32 interpolation matrix of ``method``
    (``"bilinear"`` or ``"nearest"``), on the CPU."""
    return torch.from_numpy(_interp_matrix_np(in_size, out_size, method,
                                              bool(align_corners)).copy())


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of an NHWC (or ...HWC) tensor to ``out_hw``, f32
    math, returned in ``x``'s dtype."""
    h, w = x.shape[-3], x.shape[-2]
    h2, w2 = out_hw
    if (h, w) == (h2, w2):
        return x
    ah = _interp_matrix(h, h2, "bilinear", bool(align_corners), x.device)
    aw = _interp_matrix(w, w2, "bilinear", bool(align_corners), x.device)
    y = torch.einsum("ph,...hwc->...pwc", ah, x.float())
    y = torch.einsum("qw,...pwc->...pqc", aw, y)
    return y.to(x.dtype).contiguous()


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Floor-nearest resize (cv2 ``INTER_NEAREST``) of an ...HWC tensor to
    ``out_hw``: a gather along H and W, exact for integer dtypes."""
    h, w = x.shape[-3], x.shape[-2]
    h2, w2 = out_hw
    if (h, w) == (h2, w2):
        return x
    sh = torch.from_numpy(_nearest_src(h, h2)).to(x.device)
    sw = torch.from_numpy(_nearest_src(w, w2)).to(x.device)
    return x.index_select(-3, sh).index_select(-2, sw)
