"""Hermetic synthetic triplet dataset (the JAX package's
``data/synthetic.py``, numpy only; samples are byte-identical to its for
the same seed).

Each sample is a scene of moving rectangles with constant velocity. Frames
are sampled at t, t+stride, t+2*stride, so frame 3 is exactly linearly
predictable from frames 1-2 -- a learnable task with the same data contract
as the Cityscapes loader.

Contract per sample (NHWC host arrays):
  img1, img2, img3 : (H, W, 3) float32 in [0, 1]
  seg1, seg2       : (H, W, 1) float32 class ids (model input channels)
  seg3             : (H, W)    int32 class-id target
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.colorize import CITYSCAPES_COLORS


class SyntheticTriplets:
    """``cache=True`` memoizes rendered samples in compact uint8 form
    (scenes are deterministic per index, so re-renders across epochs are
    pure waste on the single host core); ``emit_uint8=True`` returns the
    uint8 encoding directly (the pipeline's compact-transfer format,
    data/pipeline.py:encode_batch_uint8) instead of the float contract.
    Both need class ids < 256 and fall back to uncached float otherwise."""

    def __init__(self, size: int = 64, image_hw: Tuple[int, int] = (256, 256),
                 n_classes: int = 20, n_shapes: int = 6, stride: int = 3,
                 seed: int = 0, cache: bool = True,
                 emit_uint8: bool = False, n_frames: int = 3):
        self.size = size
        self.hw = image_hw
        self.n_classes = n_classes
        self.n_shapes = n_shapes
        self.stride = stride
        self.seed = seed
        # n_frames == 3 keeps the reference 6-field triplet contract;
        # n_frames > 3 emits the stacked window contract
        # {"imgs": (T,H,W,3), "segs": (T,H,W)} used by multi-step training
        # and scheduled sampling (train/multistep.py, train/scheduled.py)
        self.n_frames = n_frames
        ids_fit = n_classes <= 255
        self._cache = {} if (cache and ids_fit) else None
        self.emit_uint8 = emit_uint8 and ids_fit

    def __len__(self) -> int:
        return self.size

    def _scene(self, index: int):
        rng = np.random.default_rng((self.seed << 20) + index)
        h, w = self.hw
        shapes = []
        for _ in range(self.n_shapes):
            cls = int(rng.integers(1, self.n_classes))
            cy, cx = rng.uniform(0.15, 0.85, 2)
            hh = rng.uniform(0.05, 0.25)
            ww = rng.uniform(0.05, 0.25)
            vy, vx = rng.uniform(-0.01, 0.01, 2)
            shapes.append((cls, cy, cx, hh, ww, vy, vx))
        return shapes

    def _render(self, shapes, t: int):
        h, w = self.hw
        seg = np.zeros((h, w), np.int32)  # class 0 background
        for cls, cy, cx, hh, ww, vy, vx in shapes:
            y = cy + vy * t
            x = cx + vx * t
            y0, y1 = int((y - hh / 2) * h), int((y + hh / 2) * h)
            x0, x1 = int((x - ww / 2) * w), int((x + ww / 2) * w)
            y0, y1 = np.clip([y0, y1], 0, h)
            x0, x1 = np.clip([x0, x1], 0, w)
            seg[y0:y1, x0:x1] = cls
        img = CITYSCAPES_COLORS[seg % len(CITYSCAPES_COLORS)].astype(
            np.float32) / 255.0
        # mild deterministic shading so the RGB task is not a pure LUT
        yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
        img = np.clip(img * (0.7 + 0.3 * yy), 0.0, 1.0)
        return img, seg

    def scene_table(self) -> np.ndarray:
        """(size, n_shapes, 7) float32 scene-parameter table
        [cls, cy, cx, hh, ww, vy, vx] — the complete generative state of
        every sample, which the device renderer
        (data/device_synthetic.py) uploads once."""
        out = np.zeros((self.size, self.n_shapes, 7), np.float32)
        for i in range(self.size):
            out[i] = np.asarray(self._scene(i), np.float32)
        return out

    def sequence(self, index: int, n_frames: int):
        """Ground-truth (imgs, segs) for n_frames at stride spacing — used
        by rollout fidelity evaluation (the scene is deterministic)."""
        shapes = self._scene(index)
        imgs, segs = [], []
        for k in range(n_frames):
            img, seg = self._render(shapes, k * self.stride)
            imgs.append(img)
            segs.append(seg)
        return np.stack(imgs), np.stack(segs)

    def _sample_uint8(self, index: int) -> Dict[str, np.ndarray]:
        shapes = self._scene(index)
        if self.n_frames != 3:
            imgs, segs = [], []
            for k in range(self.n_frames):
                img, seg = self._render(shapes, k * self.stride)
                imgs.append((img * 255.0 + 0.5).astype(np.uint8))
                segs.append(seg.astype(np.uint8))
            return {"imgs": np.stack(imgs), "segs": np.stack(segs)}
        out: Dict[str, np.ndarray] = {}
        for k, t in ((1, 0), (2, self.stride), (3, 2 * self.stride)):
            img, seg = self._render(shapes, t)
            out[f"img{k}"] = (img * 255.0 + 0.5).astype(np.uint8)
            if k < 3:
                out[f"seg{k}"] = seg[..., None].astype(np.uint8)
            else:
                out["seg3"] = seg.astype(np.uint8)
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.n_frames != 3 and self._cache is None and not self.emit_uint8:
            shapes = self._scene(index)
            imgs, segs = [], []
            for k in range(self.n_frames):
                img, seg = self._render(shapes, k * self.stride)
                imgs.append(img)
                segs.append(seg)
            return {"imgs": np.stack(imgs).astype(np.float32),
                    "segs": np.stack(segs).astype(np.int32)}
        if self._cache is None and not self.emit_uint8:
            # uncached float path (ids may exceed uint8)
            shapes = self._scene(index)
            out: Dict[str, np.ndarray] = {}
            for k, t in ((1, 0), (2, self.stride), (3, 2 * self.stride)):
                img, seg = self._render(shapes, t)
                out[f"img{k}"] = img
                if k < 3:
                    out[f"seg{k}"] = seg[..., None].astype(np.float32)
                else:
                    out["seg3"] = seg
            return out
        if self._cache is not None:
            u8 = self._cache.get(index)
            if u8 is None:
                u8 = self._sample_uint8(index)
                self._cache[index] = u8
        else:
            u8 = self._sample_uint8(index)
        if self.emit_uint8:
            return u8
        if self.n_frames != 3:
            return {"imgs": u8["imgs"].astype(np.float32) / 255.0,
                    "segs": u8["segs"].astype(np.int32)}
        return {
            "img1": u8["img1"].astype(np.float32) / 255.0,
            "img2": u8["img2"].astype(np.float32) / 255.0,
            "img3": u8["img3"].astype(np.float32) / 255.0,
            "seg1": u8["seg1"].astype(np.float32),
            "seg2": u8["seg2"].astype(np.float32),
            "seg3": u8["seg3"].astype(np.int32),
        }
