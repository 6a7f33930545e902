// Single right-hand-side solve from packed LU factors.
//
// Replaces: src/repro/kernels/batched_solve.py, lu_solve (_solve_kernel +
// _two_sweep), the Pallas kernel that solves one member's system per grid
// step from its packed unpivoted L\U factor:
//
//     trans=0:  L U x = b          trans=1:  (L U)^T x = b
//
// What bounds it: a member reads its V x V factor once and does 2 V^2
// flops with it, 0.5 flop per byte, so the bound is device-memory traffic
// (B = 90 or 1080 members at V = 100 for the sw-queue stage systems).
// Inside a member the substitution is 2 V dependent row steps, so one
// member waits on latency, and many members in flight hide it.
//
// Design: one thread block per member.  The block's warps copy the factor
// into shared memory with coalesced row reads and the right-hand side
// beside it; warp 0 runs both sweeps (two_sweep.cuh), reading the factor
// by column for trans=1 instead of transposing it up front as the Pallas
// wrapper does.  The factor of one member fills at most 227 KB of shared
// memory, which caps this design at V = 240.  Above it a 256-thread block
// per member runs both sweeps by strips of 32 rows from the factor in
// global memory (strip_sweep.cuh, as chain_solve.cu's large-V variant).
// The true V is passed: no padding to a lane multiple.  Identity row permutation (the
// factors of batched_lu.cu); IEEE division, so a singular member's zero
// pivot gives inf/nan in that member's block only.

#include <cuda_runtime.h>

#include "strip_sweep.cuh"
#include "two_sweep.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
solve_kernel(const float* __restrict__ lu, const float* __restrict__ rhs,
             float* __restrict__ x, int V, int ld, int trans) {
  extern __shared__ float s[];
  float* m = s;            // (V, ld) packed factor
  float* y = m + V * ld;   // (V,) right-hand side, solved in place
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t mo = blockIdx.x * static_cast<size_t>(V) * V;
  const size_t vo = blockIdx.x * static_cast<size_t>(V);

  for (int i = warp; i < V; i += kWarps)
    for (int j = lane; j < V; j += 32) m[i * ld + j] = lu[mo + static_cast<size_t>(i) * V + j];
  for (int i = threadIdx.x; i < V; i += kThreads) y[i] = rhs[vo + i];
  __syncthreads();

  if (warp == 0) {
    repro::two_sweep_warp(m, ld, y, V, trans, lane);
    for (int i = lane; i < V; i += 32) x[vo + i] = y[i];
  }
}

__global__ void __launch_bounds__(repro::kStripThreads)
solve_kernel_strips(const float* __restrict__ lu, const float* __restrict__ rhs,
                    float* __restrict__ x, int V, int trans) {
  extern __shared__ float s[];
  float* y = s;            // (V,) right-hand side, solved in place
  float* tile = y + V;     // (32, 33) a strip's diagonal block
  const size_t vo = blockIdx.x * static_cast<size_t>(V);

  for (int i = threadIdx.x; i < V; i += blockDim.x) y[i] = rhs[vo + i];
  __syncthreads();
  repro::strip_two_sweep(lu + vo * V, V, y, trans, tile);
  for (int i = threadIdx.x; i < V; i += blockDim.x) x[vo + i] = y[i];
}

}  // namespace

extern "C" {

// Shared memory one block needs at node count V in the given variant
// (0 the factor in shared memory, 1 strips from global memory).
int repro_lu_solve_smem_bytes(int V, int variant) {
  if (variant == 1)
    return static_cast<int>(sizeof(float)) * (V + repro::kStrip * repro::kStripTileLd);
  const int ld = V | 1;
  return static_cast<int>(sizeof(float)) * (V * ld + V);
}

// lu: (B, V, V), rhs/x: (B, V), float32, contiguous.  variant 0 (the
// factor in shared memory, V <= 240) or 1 (strips), as the wrapper's
// lu_solve_plan picks it.
int repro_lu_solve(const float* lu, const float* rhs, float* x, int B, int V, int trans,
                   int variant, cudaStream_t stream) {
  if (B == 0 || V == 0) return 0;
  if (variant == 1) {
    const int smem = repro_lu_solve_smem_bytes(V, 1);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(solve_kernel_strips,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    solve_kernel_strips<<<B, repro::kStripThreads, smem, stream>>>(lu, rhs, x, V, trans);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = repro_lu_solve_smem_bytes(V, 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  solve_kernel<<<B, kThreads, smem, stream>>>(lu, rhs, x, V, V | 1, trans);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
