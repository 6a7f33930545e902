// One Neumann step of the stage fixed points, for every stage at once.
//
// Replaces: src/repro/kernels/chain_propagate.py, propagate_step (_kernel),
// the Pallas kernel that computes per stage s the row-vector product
//
//     out[s, :] = t[s, :] @ M[s, :, :] + src[s, :]
//
// (traffic sweep: M = Phi, src = injections; marginal sweep: M = Phi^T);
// solve_fixed_point iterates it, exact for loop-free routing once the
// sweeps reach the longest path.
//
// What bounds it: every entry of M is read once and used in one
// multiply-add, 0.5 flop per byte, so the bound is device-memory traffic:
// S V^2 4 bytes over 3.35 TB/s.
//
// Design: a grid over (stage, tile of kTile output columns).  The block
// stages t[s, :] in shared memory; thread w of the tile owns output column
// w and sums t[s, v] * M[s, v, w] over v in order, so the threads of a warp
// read consecutive addresses of one row of M (coalesced) and t comes from
// a shared-memory broadcast.  No padding of V.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void __launch_bounds__(kTile)
propagate_kernel(const float* __restrict__ t, const float* __restrict__ M,
                 const float* __restrict__ src, float* __restrict__ out, int V) {
  extern __shared__ float ts[];   // (V,) t[s, :]
  const size_t s = blockIdx.x;
  const int w = blockIdx.y * kTile + threadIdx.x;
  for (int v = threadIdx.x; v < V; v += kTile) ts[v] = t[s * V + v];
  __syncthreads();
  if (w >= V) return;
  const float* col = M + s * static_cast<size_t>(V) * V + w;
  float acc = 0.f;
#pragma unroll 4
  for (int v = 0; v < V; ++v) acc = fmaf(ts[v], col[static_cast<size_t>(v) * V], acc);
  out[s * V + w] = acc + src[s * V + w];
}

}  // namespace

extern "C" {

// t/src/out: (S, V), M: (S, V, V), float32, contiguous.
int repro_propagate_step(const float* t, const float* M, const float* src, float* out,
                         int S, int V, cudaStream_t stream) {
  if (S == 0 || V == 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * V;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(S, (V + kTile - 1) / kTile);
  propagate_kernel<<<grid, kTile, smem, stream>>>(t, M, src, out, V);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
