"""ctypes binding to the native image decoder (the JAX package's
``io/native_loader.py``, the same API and signatures).

``native/vlg_loader.cpp`` (at the checkout's root) decodes PNGs with zlib,
resizes with cv2's semantics (half-pixel bilinear for RGB, floor-nearest
for layout ids), encodes PNGs with libdeflate and decodes batches on a
persistent C++ thread pool that releases the GIL for the whole batch. The
library is built at first use with the Makefile's own flags
(``make -C native TARGET=...``) into ``build/vlg_native/`` at the
checkout's root, named by a hash of the source and the Makefile, so nothing
is written into ``native/``. A build or a load that fails raises
``OSError`` with the compiler's message; the callers then decode with
cv2 / PIL, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vlg_native"
_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of this checkout's source lives once built."""
    h = hashlib.sha256()
    for name in ("vlg_loader.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libvlg_loader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library if it is not built yet (race-safe across
    processes: a per-pid file renamed into place). Raises ``OSError`` with
    the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run(["make", "-s", "-C", str(NATIVE_DIR),
                              f"TARGET={tmp}"], capture_output=True,
                             text=True)
    except OSError as e:
        raise OSError(f"building the native loader failed: {e}") from e
    if out.returncode != 0 or not tmp.exists():
        raise OSError("building the native loader failed:\n"
                      + out.stdout + out.stderr)
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def _load_lib_cached() -> ctypes.CDLL:
    with _BUILD_LOCK:
        lib = ctypes.CDLL(str(build()))
    lib.vlg_load_rgb.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int]
    lib.vlg_load_rgb.restype = ctypes.c_int
    lib.vlg_load_gray_ids.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int]
    lib.vlg_load_gray_ids.restype = ctypes.c_int
    lib.vlg_pool_create.argtypes = [ctypes.c_int]
    lib.vlg_pool_create.restype = ctypes.c_void_p
    lib.vlg_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.vlg_pool_load_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.vlg_pool_load_batch.restype = ctypes.c_int
    lib.vlg_save_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    lib.vlg_save_png.restype = ctypes.c_int
    return lib


def _load_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; ``OSError`` if it
    cannot be built or loaded (a failed attempt is not cached)."""
    try:
        return _load_lib_cached()
    except OSError:
        _load_lib_cached.cache_clear()
        raise


class NativeImageLoader:
    def __init__(self, n_threads: int = 0):
        self._lib = _load_lib()
        n = n_threads or (os.cpu_count() or 1)
        self._pool = self._lib.vlg_pool_create(n)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool:
            self._lib.vlg_pool_destroy(pool)
            self._pool = None

    # -- single image --------------------------------------------------
    def load_rgb(self, path: str, hw: Tuple[int, int]) -> np.ndarray:
        """(H, W, 3) f32 RGB in [0, 1], bilinear-resized to ``hw``."""
        out = np.empty((hw[0], hw[1], 3), np.float32)
        rc = self._lib.vlg_load_rgb(
            path.encode(), out.ctypes.data_as(ctypes.c_void_p),
            hw[0], hw[1])
        if rc:
            raise FileNotFoundError(path)
        return out

    def load_gray(self, path: str, hw: Tuple[int, int]) -> np.ndarray:
        """(H, W) int32 ids, nearest-resized to ``hw``."""
        out = np.empty((hw[0], hw[1]), np.int32)
        rc = self._lib.vlg_load_gray_ids(
            path.encode(), out.ctypes.data_as(ctypes.c_void_p),
            hw[0], hw[1])
        if rc:
            raise FileNotFoundError(path)
        return out

    def save_png(self, path: str, pixels: np.ndarray, level: int = 6):
        """Write (H, W, 3) RGB or (H, W) gray uint8 pixels as a PNG
        (filter-0 rows + libdeflate; the colorized-export writer)."""
        arr = np.ascontiguousarray(pixels, np.uint8)
        ch = 1 if arr.ndim == 2 else arr.shape[2]
        rc = self._lib.vlg_save_png(
            path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
            arr.shape[0], arr.shape[1], ch, level)
        if rc:
            raise IOError(f"PNG encode failed for {path}")

    # -- batched (thread pool, GIL released) ---------------------------
    def _batch(self, paths: Sequence[str], hw, kind: int, out: np.ndarray):
        n = len(paths)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = self._lib.vlg_pool_load_batch(
            self._pool, arr, n, kind, out.ctypes.data_as(ctypes.c_void_p),
            hw[0], hw[1])
        if rc:
            raise IOError(f"{rc} of {n} images failed to decode")
        return out

    def load_rgb_batch(self, paths: Sequence[str],
                       hw: Tuple[int, int]) -> np.ndarray:
        return self._batch(paths, hw, 0, np.empty(
            (len(paths), hw[0], hw[1], 3), np.float32))

    def load_gray_batch(self, paths: Sequence[str],
                        hw: Tuple[int, int]) -> np.ndarray:
        return self._batch(paths, hw, 1, np.empty(
            (len(paths), hw[0], hw[1]), np.int32))
