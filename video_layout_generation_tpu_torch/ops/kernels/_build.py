"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/vlg_torch_kernels/lib<name>-<hash>.so``
at the checkout's root, compiled for ``sm_90a`` at first use. The hash covers
the source and the ``csrc`` headers it includes, so an edited source or header
rebuilds the libraries that read it and an unchanged one is loaded as it is. The libraries have a plain C interface:
pointers and the stream are passed as integers, and each launch function
returns the CUDA error code of its launch.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "vlg_torch_kernels"
KERNELS = ("conv3x3", "lateral", "ssim", "instance_norm")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each library's exported functions
_SIGNATURES = {
    "conv3x3": {
        "vlg_prelu_conv3x3": ([_P] * 6 + [_I] * 13 + [_P], _I),
    },
    "lateral": {
        "vlg_fused_lateral": ([_P] * 9 + [_I] * 8 + [_P], _I),
    },
    "ssim": {
        "vlg_ssim_planes": ([_P] * 3 + [_I] * 12 + [_P], _I),
        "vlg_ssim_active_clusters": ([_I] * 12, _I),
        "vlg_ssim_cluster_capacity": ([_I], _I),
    },
    "instance_norm": {
        "vlg_instance_norm_fwd": ([_P] * 3 + [_I] * 3 + [ctypes.c_float]
                                  + [_I] * 6 + [_P], _I),
        "vlg_instance_norm_bwd": ([_P] * 4 + [_I] * 9 + [_P], _I),
        "vlg_instance_norm_active_clusters": ([_I] * 10, _I),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen=None) -> list:
    """``path`` and every ``csrc`` file it includes with quotes, followed
    through the headers, each once."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            _sources(path.parent / inc, seen)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns {name: compiler
    output} for the sources compiled now. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build((name,))
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib
