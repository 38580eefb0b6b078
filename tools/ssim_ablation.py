#!/usr/bin/env python3
"""Where the SSIM kernel's time goes: its streaming alone, its arithmetic alone.

Builds two variants of ``csrc/ssim.cu`` beside the real one, each with one
half switched off by a textual patch: ``no_arithmetic`` (the consumers wait
for each row and release it, computing nothing) and ``no_copies`` (the
producer signals each row without copying it; the consumers compute on
whatever the ring holds). Each is timed with CUDA events behind a sleep
kernel (``chip_smoke.event_ms``) on the plan of the validation step's shape
and at batch 1, beside the real kernel. It also runs a micro-benchmark of
bulk-copy streaming alone: one producer thread streams rows of 3 to 24 KB
through a ring of mbarrier-guarded slots to the other warps of its CTA,
with 1, 96 and 132 CTAs, and reports clock cycles a row. Run from the root
of a checkout on a machine with one NVIDIA GPU and the CUDA toolkit:

    python3 tools/ssim_ablation.py

Prints one JSON line a measurement. The variants and the micro-benchmark
are built under ``build/ssim_ablation/``; nothing of the port uses them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ssim_ablation")
PATCHES = {
    "no_arithmetic": ("    if (OUT) {", "    if (false) {"),
    "no_copies": ("            if (bulk != 0) {", "            if (false) {"),
}
BULK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ unsigned sa(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wait(uint64_t* b, unsigned ph) {
  unsigned done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(sa(b)), "r"(ph) : "memory");
  } while (!done);
}
// thread `consumers` streams `rows` rows of `bytes` into `stages` slots;
// the consumer warps wait for each, read one value and release it
extern "C" __global__ void stream_rows(const char* src, long long* cycles,
                                       int rows, int bytes, int stages,
                                       int consumers) {
  extern __shared__ __align__(16) unsigned char sm[];
  uint64_t* full = (uint64_t*)sm;
  uint64_t* empty = full + stages;
  unsigned char* ring = sm + 16 * stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(sa(full + s)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(sa(empty + s)), "r"(consumers / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long t0 = clock64();
  const char* base = src + (size_t)blockIdx.x * rows * bytes;
  if (threadIdx.x == consumers) {
    int s = 0, lap = 0;
    for (int r = 0; r < rows; ++r) {
      if (lap) wait(empty + s, (lap - 1) & 1);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(sa(full + s)), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                   "complete_tx::bytes [%0], [%1], %2, [%3];"
                   ::"r"(sa(ring + (size_t)s * bytes)),
                   "l"(base + (size_t)r * bytes), "r"(bytes),
                   "r"(sa(full + s)) : "memory");
      if (++s == stages) { s = 0; ++lap; }
    }
  } else if (threadIdx.x < consumers) {
    int s = 0;
    unsigned ph = 0;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      wait(full + s, ph);
      acc += ((float*)(ring + (size_t)s * bytes))[threadIdx.x % (bytes / 4)];
      __syncwarp();
      if ((threadIdx.x & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     ::"r"(sa(empty + s)) : "memory");
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    if (acc == -1.f) cycles[0] = 1;   // keeps the reads
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[1 + blockIdx.x] = clock64() - t0;
}
extern "C" int launch(const char* src, long long* cycles, int ctas, int rows,
                      int bytes, int stages, int consumers) {
  const int smem = 16 * stages + stages * bytes;
  cudaFuncSetAttribute(stream_rows,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stream_rows<<<ctas, consumers + 32, smem>>>(src, cycles, rows, bytes,
                                              stages, consumers);
  return (int)cudaGetLastError();
}
"""


def nvcc(build, src, lib):
    return subprocess.Popen(
        [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ssim_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video_layout_generation_tpu_torch.ops.kernels import _build
    from video_layout_generation_tpu_torch.ops.kernels import ssim as mod
    from video_layout_generation_tpu_torch.ops.kernels._checks import \
        stream_ptr

    os.makedirs(OUT, exist_ok=True)
    source = open(os.path.join(_build.CSRC, "ssim.cu")).read()
    procs = {}
    for name, (old, new) in PATCHES.items():
        if source.count(old) != 1:
            raise SystemExit(f"ssim_ablation: patch {name} does not apply")
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(source.replace(old, new))
        procs[name] = nvcc(_build, path, os.path.join(OUT, f"lib{name}.so"))
    bulk_src = os.path.join(OUT, "bulk.cu")
    with open(bulk_src, "w") as f:
        f.write(BULK_CU)
    procs["bulk"] = nvcc(_build, bulk_src, os.path.join(OUT, "libbulk.so"))
    libs = {"kernel": _build.library("ssim")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssim_ablation: nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    for name in ("kernel",) + tuple(PATCHES):
        fn = libs[name].vlg_ssim_planes
        fn.argtypes, fn.restype = _build._SIGNATURES["ssim"]["vlg_ssim_planes"]

    dev = torch.device("cuda")
    card = cs.card_line()
    for shape in ((16, 256, 256, 3), (1, 256, 256, 3)):
        n, h, w, c = shape
        pairs = cs.ssim_inputs(torch, shape, torch.float32, False, 3)
        plan = mod.plan_for(pairs[0][0])
        out = torch.empty((n, c), device=dev)
        for name in ("kernel",) + tuple(PATCHES):
            fn = libs[name].vlg_ssim_planes
            turn = [0]

            def call():
                turn[0] = (turn[0] + 1) % len(pairs)
                x, y = pairs[turn[0]]
                err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, h, w,
                         c, 0, *mod._plan_args(plan), stream_ptr(x.device))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            print(json.dumps(dict(card=card, variant=name, shape=list(shape),
                                  plan=plan,
                                  ms=cs.event_ms(torch, call, 200))),
                  flush=True)

    lib = libs["bulk"]
    lib.launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cycles = torch.zeros(1 + 132, dtype=torch.int64, device=dev)
    for ctas, rows, nbytes, stages in ((1, 64, 3072, 32), (1, 64, 6144, 16),
                                       (1, 64, 12288, 16), (1, 64, 24576, 8),
                                       (96, 45, 6144, 20), (132, 34, 6144, 20)):
        for _ in range(3):
            err = lib.launch(src.data_ptr(), cycles.data_ptr(), ctas, rows,
                             nbytes, stages, 192)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"bulk: CUDA error {err}")
        most = float(cycles[1:1 + ctas].max())
        print(json.dumps(dict(card=card, microbenchmark="bulk rows",
                              ctas=ctas, rows=rows, bytes=nbytes,
                              stages=stages, cycles=most,
                              cycles_a_row=most / rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
