"""GridNet, CoordGridNet, HNED and VGG19 to relu4_4 as plain functions of a
parameter dict, in float32.

Written from the reference repository (gongaa/video-layout-generation,
``src/models/gridnet.py``: a 3 x 6 grid of lateral, down- and up-sampling
blocks, PReLU before every conv, additive fusion; the HED edge net; VGG19
features) and not from the port. Parameters are named as the flax tree of
the JAX package names them (``col_1.lateral_00.Conv_0.kernel``, HWIO
kernels), which is also what the port's ``state_dict`` calls them, so that
one dict of weights made by the benchmark loads into both.

Activations are NHWC at the boundaries and NCHW inside. Two hooks:

- ``q``: applied to the input and the kernel of every convolution (None:
  float32 as is). The control of ``quant.py`` passes a float8 rounding.
- ``rec``: called once for each 3 x 3 convolution launch that the port's
  kernels make for this call, ``rec(kind, n, h, w, ci, co, stride,
  residual)``: kind ``"B"`` for a channel-preserving lateral block without
  shortcut (one launch of kernel B for both convs), ``"A"`` for every other
  3 x 3 conv. ``counts.py`` turns these into operations and bytes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OUT_MEAN = (-0.03, -0.088, -0.188)
OUT_STD = (0.448, 0.448, 0.450)
CAFFE_MEANS_BGR = (104.00698793, 116.66876762, 122.67891434)
HNED_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
               (512, 512, 512))
VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256),
              (512, 512, 512, 512))


# ---- parameter specs: (name, shape, kind) ----------------------------------

def _conv_spec(prefix: str, cin: int, cout: int, k: int = 3) -> list:
    return [(f"{prefix}.kernel", (k, k, cin, cout), "kernel"),
            (f"{prefix}.bias", (cout,), "bias")]


def _lateral_spec(p: str, cin: int, cout: int, shortcut: bool = False):
    out = [(f"{p}.PReLU_0.alpha", (), "alpha")]
    out += _conv_spec(f"{p}.Conv_0", cin, cout)
    out += [(f"{p}.PReLU_1.alpha", (), "alpha")]
    out += _conv_spec(f"{p}.Conv_1", cout, cout)
    if shortcut:
        out += _conv_spec(f"{p}.Conv_2", cin, cout)
    return out


def _coord_lateral_spec(p: str, cin: int, cout: int) -> list:
    return (_conv_spec(f"{p}.CoordConv_0.Conv_0", cin + 2, cout)
            + [(f"{p}.PReLU_0.alpha", (), "alpha")]
            + _conv_spec(f"{p}.CoordConv_1.Conv_0", cout + 2, cout)
            + _conv_spec(f"{p}.CoordConv_2.Conv_0", cin + 2, cout))


def gridnet_spec(n_channels: int, filters: Sequence[int], coord: bool,
                 seg_out: int = 20, img_out: int = 3) -> list:
    f0, f1, f2 = filters
    spec = (_coord_lateral_spec("lateral_in", n_channels, f0) if coord
            else _lateral_spec("lateral_in", n_channels, f0, shortcut=True))
    spec += _lateral_spec("down_00", f0, f1) + _lateral_spec("down_10", f1, f2)
    for i in range(1, 6):
        c = f"col_{i}"
        if i < 3:
            spec += (_lateral_spec(f"{c}.lateral_0{i-1}", f0, f0)
                     + _lateral_spec(f"{c}.down_0{i}", f0, f1)
                     + _lateral_spec(f"{c}.lateral_1{i-1}", f1, f1)
                     + _lateral_spec(f"{c}.down_1{i}", f1, f2)
                     + _lateral_spec(f"{c}.lateral_2{i-1}", f2, f2))
        else:
            spec += (_lateral_spec(f"{c}.lateral_2{i-1}", f2, f2)
                     + _lateral_spec(f"{c}.up_1{i}", f2, f1)
                     + _lateral_spec(f"{c}.lateral_1{i-1}", f1, f1)
                     + _lateral_spec(f"{c}.up_0{i}", f1, f0)
                     + _lateral_spec(f"{c}.lateral_0{i-1}", f0, f0))
    spec += _lateral_spec("lateral_out_seg", f0, seg_out)
    spec += _lateral_spec("lateral_out_img", f0, img_out)
    return spec


def hned_spec() -> list:
    spec, cin = [], 3
    for b, widths in enumerate(HNED_STAGES):
        for j, f in enumerate(widths):
            spec += _conv_spec(f"vgg{b+1}_{j}", cin, f)
            cin = f
        spec += _conv_spec(f"score{b+1}", cin, 1, k=1)
    return spec + _conv_spec("combine", len(HNED_STAGES), 1, k=1)


def vgg_spec() -> list:
    spec, cin = [], 3
    for b, widths in enumerate(VGG_BLOCKS):
        for j, f in enumerate(widths):
            spec += _conv_spec(f"conv{b+1}_{j+1}", cin, f)
            cin = f
    return spec


# ---- building blocks (NCHW) -------------------------------------------------

def _const(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32,
                        device=like.device).view(1, -1, 1, 1)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def conv(x, p: Params, name: str, stride: int = 1, q=None) -> torch.Tensor:
    w = p[f"{name}.kernel"]
    k = w.shape[0]
    w = w.permute(3, 2, 0, 1)
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, p[f"{name}.bias"], stride=stride, padding=k // 2)


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Two coordinate channels in [-1, 1]: the first varies along H."""
    n, _, h, w = x.shape
    hh = torch.arange(h, dtype=x.dtype, device=x.device) / max(h - 1, 1)
    ww = torch.arange(w, dtype=x.dtype, device=x.device) / max(w - 1, 1)
    hh = (hh * 2 - 1).view(1, 1, h, 1).expand(n, 1, h, w)
    ww = (ww * 2 - 1).view(1, 1, 1, w).expand(n, 1, h, w)
    return torch.cat([x, hh, ww], dim=1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class _Net:
    """The forward pass of one net: its parameters, ``q`` and ``rec``."""

    def __init__(self, p: Params, q=None, rec: Optional[Callable] = None):
        self.p, self.q, self.rec = p, q, rec

    def record(self, kind, x, co, stride=1, residual=False):
        if self.rec is not None:
            n, ci, h, w = x.shape
            self.rec(kind, n, h, w, ci, co, stride, residual)

    def conv3(self, x, name, stride=1, residual=None, alpha=None):
        co = self.p[f"{name}.kernel"].shape[3]
        self.record("A", x, co, stride, residual is not None)
        xa = x if alpha is None else prelu(x, self.p[alpha])
        y = conv(xa, self.p, name, stride, self.q)
        return y if residual is None else y + residual

    def lateral(self, x, p, residual=None):
        w0 = self.p[f"{p}.Conv_0.kernel"]
        ci, co = w0.shape[2], w0.shape[3]
        if f"{p}.Conv_2.kernel" not in self.p and ci == co:
            self.record("B", x, co, 1, residual is not None)
            rec, self.rec = self.rec, None
            try:
                return self._lateral(x, p, residual)
            finally:
                self.rec = rec
        return self._lateral(x, p, residual)

    def _lateral(self, x, p, residual):
        s = residual
        if f"{p}.Conv_2.kernel" in self.p:
            s = self.conv3(x, f"{p}.Conv_2", residual=residual)
        y = self.conv3(x, f"{p}.Conv_0", alpha=f"{p}.PReLU_0.alpha")
        return self.conv3(y, f"{p}.Conv_1", residual=s,
                          alpha=f"{p}.PReLU_1.alpha")

    def down(self, x, p, residual=None):
        y = self.conv3(x, f"{p}.Conv_0", stride=2, alpha=f"{p}.PReLU_0.alpha")
        return self.conv3(y, f"{p}.Conv_1", residual=residual,
                          alpha=f"{p}.PReLU_1.alpha")

    def up(self, x, p, residual=None):
        y = self.conv3(upsample2x(x), f"{p}.Conv_0",
                       alpha=f"{p}.PReLU_0.alpha")
        return self.conv3(y, f"{p}.Conv_1", residual=residual,
                          alpha=f"{p}.PReLU_1.alpha")

    def coord_lateral(self, x, p):
        s = self.conv3(add_coords(x), f"{p}.CoordConv_2.Conv_0")
        y = self.conv3(add_coords(x), f"{p}.CoordConv_0.Conv_0")
        y = prelu(y, self.p[f"{p}.PReLU_0.alpha"])
        return self.conv3(add_coords(y), f"{p}.CoordConv_1.Conv_0",
                          residual=s)


def gridnet(p: Params, x_nhwc: torch.Tensor, q=None, rec=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) -> (seg logits (N, 20, H, W), img (N, 3, H, W))."""
    net = _Net(p, q, rec)
    x = x_nhwc.permute(0, 3, 1, 2)
    if "lateral_in.CoordConv_0.Conv_0.kernel" in p:
        x0 = net.coord_lateral(x, "lateral_in")
    else:
        x0 = net.lateral(x, "lateral_in")
    x1 = net.down(x0, "down_00")
    x2 = net.down(x1, "down_10")
    for i in range(1, 6):
        c = f"col_{i}"
        if i < 3:
            x0 = net.lateral(x0, f"{c}.lateral_0{i-1}")
            x1 = net.lateral(x1, f"{c}.lateral_1{i-1}",
                             net.down(x0, f"{c}.down_0{i}"))
            x2 = net.lateral(x2, f"{c}.lateral_2{i-1}",
                             net.down(x1, f"{c}.down_1{i}"))
        else:
            x2 = net.lateral(x2, f"{c}.lateral_2{i-1}")
            x1 = net.lateral(x1, f"{c}.lateral_1{i-1}",
                             net.up(x2, f"{c}.up_1{i}"))
            x0 = net.lateral(x0, f"{c}.lateral_0{i-1}",
                             net.up(x1, f"{c}.up_0{i}"))
    return net.lateral(x0, "lateral_out_seg"), net.lateral(x0,
                                                           "lateral_out_img")


def hned_edge(p: Params, rgb_nhwc: torch.Tensor, q=None, rec=None
              ) -> torch.Tensor:
    """The fused HED edge map (N, H, W, 1) of RGB frames in [0, 1]: caffe
    scaling, RGB -> BGR, mean subtraction, 13 conv -> ReLU in 5 stages,
    a 1 x 1 score a stage resized back bilinearly, a 1 x 1 fuse and a
    sigmoid."""
    net = _Net(p, q, rec)
    h, w = rgb_nhwc.shape[1], rgb_nhwc.shape[2]
    x = (rgb_nhwc * 255.0).flip(-1).permute(0, 3, 1, 2)
    x = x - _const(CAFFE_MEANS_BGR, x)
    scores = []
    for b, widths in enumerate(HNED_STAGES):
        if b > 0:
            x = F.max_pool2d(x, 2, 2)
        for j in range(len(widths)):
            x = torch.relu(net.conv3(x, f"vgg{b+1}_{j}"))
        s = conv(x, p, f"score{b+1}", q=q)
        scores.append(F.interpolate(s, size=(h, w), mode="bilinear",
                                    align_corners=False))
    fuse = torch.sigmoid(conv(torch.cat(scores, dim=1), p, "combine", q=q))
    return fuse.permute(0, 2, 3, 1)


def vgg_features(p: Params, x_nchw: torch.Tensor, q=None, rec=None
                 ) -> torch.Tensor:
    net = _Net(p, q, rec)
    x = x_nchw
    for b, widths in enumerate(VGG_BLOCKS):
        if b > 0:
            x = F.max_pool2d(x, 2, 2)
        for j in range(len(widths)):
            x = torch.relu(net.conv3(x, f"conv{b+1}_{j+1}"))
    return x


def normalize_image(img_nchw: torch.Tensor) -> torch.Tensor:
    return ((img_nchw - _const(IMAGENET_MEAN, img_nchw))
            / _const(IMAGENET_STD, img_nchw))


def denormalize_image(img_nchw: torch.Tensor) -> torch.Tensor:
    return (img_nchw * _const(IMAGENET_STD, img_nchw)
            + _const(IMAGENET_MEAN, img_nchw))


def normalize_model_output(img_nchw: torch.Tensor) -> torch.Tensor:
    return ((img_nchw - _const(OUT_MEAN, img_nchw))
            / _const(OUT_STD, img_nchw))


def model_input(e_old, s_old, f_old, f_new, s_new, e_new) -> torch.Tensor:
    """The 10-channel NHWC input [edge, seg, frame, frame, seg, edge] from
    NCHW frames (normalized), NHWC edges and (N, H, W) layout ids."""
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    return torch.cat([e_old, s_old.float()[..., None], nhwc(f_old),
                      nhwc(f_new), s_new.float()[..., None], e_new], dim=-1)


def names(spec: List[tuple]) -> List[str]:
    return [n for n, _, _ in spec]
