"""Cityscapes video-snippet triplet index (the JAX package's
``data/index.py``, numpy and the standard library only): given a root containing
``deeplab256_label/<city>/`` (segmentation ids) and ``leftImg256/<city>/``
(RGB frames), group frames per snippet, find contiguous frame runs, and
emit every stride-3 triplet (t, t+3, t+6) inside a run. Filename contract:
``{city}_{snippet:06d}_{frame:06d}_gtFine_myseg_id.png`` and
``..._leftImg8bit.png``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

SEG_SUBDIR = "deeplab256_label"
IMG_SUBDIR = "leftImg256"
SEG_SUFFIX = "_gtFine_myseg_id.png"
IMG_SUFFIX = "_leftImg8bit.png"

TripletEntry = Tuple[List[str], List[str]]  # ([seg x3], [img x3])


def _contiguous_runs(sorted_ints: List[int]) -> List[List[int]]:
    runs: List[List[int]] = []
    for v in sorted_ints:
        if runs and v == runs[-1][-1] + 1:
            runs[-1].append(v)
        else:
            runs.append([v])
    return runs


def build_triplet_index(root: str, stride: int = 3,
                        n_frames: int = 3) -> List[TripletEntry]:
    """Walk the dataset tree and emit (seg_paths, img_paths) triplets."""
    root = os.path.expanduser(root)
    seg_root = os.path.join(root, SEG_SUBDIR)
    img_root = os.path.join(root, IMG_SUBDIR)
    span = stride * (n_frames - 1)
    entries: List[TripletEntry] = []
    for city in sorted(os.listdir(seg_root)):
        city_dir = os.path.join(seg_root, city)
        if not os.path.isdir(city_dir):
            continue
        files = [f for f in os.listdir(city_dir) if f.endswith(".png")]
        # group by snippet id (field 1 of the underscore-split name)
        by_snippet: dict = {}
        for f in files:
            parts = f.split("_")
            by_snippet.setdefault(int(parts[1]), []).append(int(parts[2]))
        for snippet in sorted(by_snippet):
            frames = sorted(set(by_snippet[snippet]))
            for run in _contiguous_runs(frames):
                # note: the reference iterates range(r[0], r[-1]-6), i.e. the
                # last valid start is r[-1]-7; we keep that windowing exactly
                # so sample counts match.
                for t in range(run[0], run[-1] - span):
                    stem = f"{city}_{snippet:06d}_"
                    ts = [t + k * stride for k in range(n_frames)]
                    seg_paths = [os.path.join(seg_root, city,
                                              f"{stem}{ti:06d}{SEG_SUFFIX}")
                                 for ti in ts]
                    img_paths = [os.path.join(img_root, city,
                                              f"{stem}{ti:06d}{IMG_SUFFIX}")
                                 for ti in ts]
                    entries.append((seg_paths, img_paths))
    return entries
