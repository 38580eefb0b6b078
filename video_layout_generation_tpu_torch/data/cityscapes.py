"""Cityscapes triplet dataset, decoded on the host (the JAX package's
``data/cityscapes.py``): 3 segmentation maps (grayscale, nearest-resized to
the target size) and 3 RGB frames (BGR -> RGB) per sample, in the 6-field
contract of ``data/synthetic.py``.

Decoders, fastest available first, as in the JAX package: the native C++
loader (``io/native_loader.py``, built from ``native/vlg_loader.cpp`` at
first use), then cv2, then PIL. A native loader that cannot be built or
loaded (``OSError``) falls back to cv2 / PIL; ``decoder`` names the one a
dataset uses and ``native_error`` keeps the build's message. With neither
cv2 nor PIL installed, the fallback raises ``ImportError`` naming both.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..io.native_loader import NativeImageLoader
from .index import build_triplet_index

try:
    import cv2
except ImportError:  # pragma: no cover - PIL decodes instead
    cv2 = None

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _no_decoder() -> ImportError:
    return ImportError("reading Cityscapes PNGs needs cv2 (opencv-python) "
                       "or PIL (Pillow); neither is installed")


def _load_rgb(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) f32 RGB in [0, 1], bilinear-resized to ``hw``."""
    if cv2 is not None:
        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(path)
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        if im.shape[:2] != tuple(hw):
            im = cv2.resize(im, dsize=(hw[1], hw[0]),
                            interpolation=cv2.INTER_LINEAR)
        return im.astype(np.float32) / 255.0
    if Image is None:
        raise _no_decoder()
    im = Image.open(path).convert("RGB")
    if im.size != (hw[1], hw[0]):
        im = im.resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0


def _load_seg(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) int32 class ids, nearest-resized to ``hw``."""
    if cv2 is not None:
        im = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if im is None:
            raise FileNotFoundError(path)
        if im.shape[:2] != tuple(hw):
            im = cv2.resize(im, dsize=(hw[1], hw[0]),
                            interpolation=cv2.INTER_NEAREST)
        return im.astype(np.int32)
    if Image is None:
        raise _no_decoder()
    im = Image.open(path).convert("L")
    if im.size != (hw[1], hw[0]):
        im = im.resize((hw[1], hw[0]), Image.NEAREST)
    return np.asarray(im, np.int32)


def fallback_decoder() -> str:
    """The decoder used without the native loader: ``cv2`` or ``PIL``."""
    return "cv2" if cv2 is not None else "PIL"


class _Decoding:
    """The native loader when it builds and loads, else cv2 / PIL."""

    def _init_decoder(self, use_native: bool):
        self._native = None
        self.native_error = None
        if use_native and NativeImageLoader is not None:
            try:
                self._native = NativeImageLoader()
            except OSError as e:
                self.native_error = str(e)
        self.decoder = "native" if self._native else fallback_decoder()

    def _rgb(self, path: str) -> np.ndarray:
        if self._native is not None:
            return self._native.load_rgb(path, self.hw)
        return _load_rgb(path, self.hw)

    def _seg(self, path: str) -> np.ndarray:
        if self._native is not None:
            return self._native.load_gray(path, self.hw)
        return _load_seg(path, self.hw)


class CityscapesTriplets(_Decoding):
    def __init__(self, root: str, image_hw: Tuple[int, int] = (256, 256),
                 use_native: bool = True):
        self.samples = build_triplet_index(root)
        if not self.samples:
            raise RuntimeError(f"Found 0 triplets under {root}")
        self.hw = tuple(image_hw)
        self._init_decoder(use_native)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        seg_paths, img_paths = self.samples[index]
        imgs = [self._rgb(p) for p in img_paths]
        segs = [self._seg(p) for p in seg_paths]
        return {
            "img1": imgs[0], "img2": imgs[1], "img3": imgs[2],
            "seg1": segs[0][..., None].astype(np.float32),
            "seg2": segs[1][..., None].astype(np.float32),
            "seg3": segs[2].astype(np.int32),
        }


class CityscapesSequences(CityscapesTriplets):
    """N-frame stride-3 windows: ``sequence(i, n)`` returns ground-truth
    (imgs (n,H,W,3), segs (n,H,W)) for rollout fidelity evaluation, and a
    sample is the stacked window {"imgs": (T,H,W,3) f32, "segs": (T,H,W)
    i32}."""

    def __init__(self, root: str, n_frames: int = 10,
                 image_hw: Tuple[int, int] = (256, 256),
                 use_native: bool = True):
        self.n_frames = n_frames
        self.samples = build_triplet_index(root, stride=3,
                                           n_frames=n_frames)
        if not self.samples:
            raise RuntimeError(
                f"Found 0 {n_frames}-frame windows under {root}")
        self.hw = tuple(image_hw)
        self._init_decoder(use_native)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        imgs, segs = self.sequence(index, self.n_frames)
        return {"imgs": imgs.astype(np.float32), "segs": segs}

    def sequence(self, index: int, n_frames: int):
        seg_paths, img_paths = self.samples[index]
        n = min(n_frames, len(img_paths))
        imgs = [self._rgb(p) for p in img_paths[:n]]
        segs = [self._seg(p) for p in seg_paths[:n]]
        return np.stack(imgs), np.stack(segs).astype(np.int32)
