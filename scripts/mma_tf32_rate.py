#!/usr/bin/env python3
"""The card's rate of ``mma.sync`` TF32 products, the ceiling of the model kernels.

    python3 scripts/mma_tf32_rate.py

``flash_attention.cu`` and ``ssd_chunk.cu`` multiply with
``mma.sync.aligned.m16n8k8`` on TF32 operands, three products per float32
product (big x big, big x small, small x big).  This measures, on one
card, how many TF32 FLOP/s such a stream of ``mma.sync`` reaches when
nothing else runs (``split=False``: eight independent accumulators per
warp, the three products of each issued term by term as the kernels do),
and when each B operand is split as the kernels split it
(``cvt.rna.tf32.f32``, mask, subtract, ``cvt.rna``: eight instructions per
three products; ``split=True``).  A third of either is the float32-accurate
rate the kernels can reach.  Prints one JSON line per case and the card's
``nvidia-smi`` name and power limit.  Builds into ``build/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%5,%6}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) : "r"(a), "r"(b0), "r"(b1));
}

template <bool SPLIT>
__global__ void stream(float* out, int iters, float seed) {
  constexpr int K = 8;
  float acc[K][4] = {};
  const uint32_t a = __float_as_uint(seed + threadIdx.x), b = __float_as_uint(2 * seed);
  float x = seed * threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    uint32_t bb[K], bs[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (SPLIT) {
        const float v = x + k;
        uint32_t r, s;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
        r &= 0xffffe000u;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s) : "f"(v - __uint_as_float(r)));
        bb[k] = r, bs[k] = s;
      } else {
        bb[k] = b + k, bs[k] = b - k;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) mma(acc[k], a, bs[k], bb[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) mma(acc[k], a, bb[k], bs[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) mma(acc[k], a, bb[k], bb[k]);
    x += 1.0f;
  }
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Milliseconds of one launch of `blocks` blocks of `warps` warps, each warp
// issuing 24 mma per iteration; negative on a CUDA error.
extern "C" float mma_stream_ms(int split, int blocks, int warps, int iters) {
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * blocks * warps * 32) != cudaSuccess) return -1.f;
  auto run = [&](int n) {
    if (split) stream<true><<<blocks, 32 * warps>>>(out, n, 1.f);
    else stream<false><<<blocks, 32 * warps>>>(out, n, 1.f);
  };
  run(16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  run(iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return ms;
}
"""


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 1
    build = os.path.join(HERE, "build", "mma_tf32_rate")
    os.makedirs(build, exist_ok=True)
    src, lib = os.path.join(build, "mma_tf32_rate.cu"), os.path.join(build, "mma_tf32_rate.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).mma_stream_ms
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for split in (False, True):
        for warps, per_sm in ((8, 1), (8, 2), (16, 2)):
            blocks = sms * per_sm
            ms = fn(int(split), blocks, warps, iters)
            if ms <= 0:
                print("mma_tf32_rate: launch failed", file=sys.stderr)
                return 1
            flops = 2.0 * 16 * 8 * 8 * 24 * iters * blocks * warps
            print(json.dumps({"split": split, "warps_per_sm": warps * per_sm, "ms": ms,
                              "tf32_tflops": flops / ms / 1e9,
                              "float32_tflops_three_term": flops / ms / 1e9 / 3}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
