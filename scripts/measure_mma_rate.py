#!/usr/bin/env python3
"""Measure the tensor cores' rate through ``mma.sync`` on one CUDA card.

    python3 scripts/measure_mma_rate.py

Builds (``nvcc``, into ``build/mma_rate/``) a kernel whose warps issue
``mma.sync`` back to back on ``--chains`` independent accumulators, with
operands in registers and nothing else in the loop, and times it with
CUDA events for ``m16n8k8`` TF32 (the 3xTF32 kernels' product) and
``m16n8k16`` bf16, at 4, 8 and 16 warps an SM.  Prints the card's name
and power limit, then one JSON line of TFLOP/s.  This is the ceiling a
kernel built on ``mma.sync`` works under, beside the data sheet's dense
peaks (495 TFLOP/s TF32, 989 bf16, which ``wgmma`` reaches).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains>
__global__ void tf32_loop(float* out, int iters) {
  float acc[kChains][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kChains>
__global__ void bf16_loop(float* out, int iters) {
  float acc[kChains][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3c003c00u + threadIdx.x - i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int kind, int blocks, int threads, int iters, float* out,
                   float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {  // the first is a warm-up
    cudaEventRecord(e0);
    if (kind == 0) tf32_loop<8><<<blocks, threads>>>(out, iters);
    else bf16_loop<8><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("measure_mma_rate: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels._build import _nvcc

    build = ROOT / "build" / "mma_rate"
    build.mkdir(parents=True, exist_ok=True)
    (build / "mma_rate.cu").write_text(SOURCE)
    lib_path = build / "mma_rate.so"
    subprocess.run([_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(build / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.run.restype = ctypes.c_int
    print(smoke.card_line())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32 * 4, device="cuda")
    chains, iters = 8, 20000
    rows = []
    for kind, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                             (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            ms = ctypes.c_float()
            err = lib.run(kind, sms, 32 * warps, iters, out.data_ptr(),
                          ctypes.byref(ms))
            if err:
                raise RuntimeError(f"launch failed: {err}")
            tflops = (sms * warps * iters * chains * flop
                      / (ms.value * 1e-3) / 1e12)
            rows.append(dict(mma=name, warps_per_sm=warps, ms=ms.value,
                             tflops=tflops))
            print(f"{name}, {warps} warps an SM: {tflops:.1f} TFLOP/s")
    print(json.dumps({"mma_rate": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
