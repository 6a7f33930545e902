// Fused chain solve over a stack of packed LU factors.
//
// Replaces: src/repro/kernels/batched_solve.py, chain_solve
// (_chain_solve_kernel + _two_sweep), the Pallas kernel that walks one
// member's K stages inside one kernel invocation:
//
//     x_k = A_k^{-1(T)} (base_k + mult_k * x_prev),   x_prev(start) = 0,
//
// forward in k, or backward with reverse; trans=1 solves the transposed
// system from the same factors; clamp keeps x >= 0 (NaN stays NaN).
//
// What bounds it: each stage reads a V x V factor once and does 2 V^2
// flops with it (two triangular sweeps), 0.5 flop per byte, so the bound
// is device-memory traffic (sw-queue: B = 30, 30 and 360 chains of K = 3
// stages at V = 100).  Inside a stage the substitution is a chain of V
// dependent row steps per sweep, so latency, not bandwidth, is what a
// single chain waits on.
//
// Design: one thread block per chain.  The block's warps load the stage's
// factor into shared memory with coalesced row reads; x_prev and the
// right-hand side stay in shared memory across the K stages, so the
// sequential chain never leaves the SM.  Warp 0 then runs both sweeps
// (two_sweep.cuh: one warp-reduced dot product per row; trans=1 reads the
// factor by column).  Many chains run concurrently, one block each.
//
// Identity row permutation assumed (the unpivoted factors of batched_lu.cu).
// IEEE division; the clamp is written so that NaN propagates as
// jnp.maximum(nan, 0) does (fmaxf alone would return 0).

#include <cuda_runtime.h>

#include "two_sweep.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ lu, const float* __restrict__ base,
             const float* __restrict__ mult, float* __restrict__ x_out,
             int K, int V, int ld, int trans, int reverse, int clamp) {
  extern __shared__ float s[];
  float* m = s;             // (V, ld) factor of the current stage
  float* xv = m + V * ld;   // (V,) x_prev, then this stage's solution
  float* y = xv + V;        // (V,) right-hand side, solved in place
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t chain = blockIdx.x;

  for (int i = threadIdx.x; i < V; i += kThreads) xv[i] = 0.f;

  for (int step = 0; step < K; ++step) {
    const int k = reverse ? K - 1 - step : step;
    const size_t mo = (chain * K + k) * static_cast<size_t>(V) * V;
    const size_t vo = (chain * K + k) * static_cast<size_t>(V);
    __syncthreads();  // the previous stage is done with m, xv and y
    for (int i = warp; i < V; i += kWarps)
      for (int j = lane; j < V; j += 32) m[i * ld + j] = lu[mo + static_cast<size_t>(i) * V + j];
    for (int i = threadIdx.x; i < V; i += kThreads) y[i] = base[vo + i] + mult[vo + i] * xv[i];
    __syncthreads();

    if (warp == 0) {
      repro::two_sweep_warp(m, ld, y, V, trans, lane);
      for (int i = lane; i < V; i += 32) {
        float v = y[i];
        if (clamp) v = (v != v) ? v : fmaxf(v, 0.f);
        xv[i] = v;
        x_out[vo + i] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at node count V.
int repro_chain_solve_smem_bytes(int V) {
  const int ld = V | 1;
  return static_cast<int>(sizeof(float)) * (V * ld + 2 * V);
}

// lu: (B, K, V, V), base/mult/x: (B, K, V), float32, contiguous.
int repro_chain_solve(const float* lu, const float* base, const float* mult, float* x,
                      int B, int K, int V, int trans, int reverse, int clamp,
                      cudaStream_t stream) {
  if (B == 0 || K == 0 || V == 0) return 0;
  const int ld = V | 1;
  const int smem = repro_chain_solve_smem_bytes(V);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_kernel<<<B, kThreads, smem, stream>>>(lu, base, mult, x, K, V, ld, trans, reverse, clamp);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
