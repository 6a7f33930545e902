// Bit-packed "tagged node" fixed point behind the blocked node sets.
//
// Replaces: src/repro/kernels/blocked_sets.py, tagged_pallas
// (_tagged_kernel), the Pallas kernel that iterates, per (app, stage),
//
//     tagged[p] = OR_q route[p, q] & (improper[p, q] | tagged[q])
//
// on uint32-packed rows until the bitset stops changing (at most Vp + 1
// rounds), and returns the packed bitset.
//
// What bounds it: the inputs are two (Vp, W) word matrices per member
// (4 KB at sw-queue: Vp = 128, W = 4, B = 90) and each round does 3 word
// operations per word, a few rounds deep (the routing DAG's diameter), so
// the arithmetic is tiny and the bound is reading the words once.  What a
// member actually waits on is the chain of dependent rounds.
//
// Design: one thread block per member; both word matrices go into shared
// memory once and every round reads them from there.  Thread p computes
// hit_p = OR_w (imp[p, w] | (route[p, w] & tagged[w])) != 0, and
// __ballot_sync turns a warp's 32 hits directly into word p/32, bit p%32,
// which is exactly pack_bits' layout.  The loop exits when a round leaves
// the bitset unchanged (__syncthreads_or over a change flag), with the
// reference's cap of Vp + 1 rounds.  The map is monotone, so the result is
// the least fixed point, bit-equal to the dense V-round sweep.
//
// Above Vp = 960 (2 Vp W words no longer fit one block's shared memory;
// V = 1000 on the dense route) the same rounds read the two word matrices
// from global memory, where L2 keeps them between rounds (2 x 128 KB a
// member at Vp = 1024); only the two bitsets stay in shared memory.  The
// same words and the same rounds, so the same bitset.
//
// Words are passed as int32 tensors (PyTorch's uint32 lacks CPU shifts)
// and read here as uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
tagged_kernel(const uint32_t* __restrict__ route, const uint32_t* __restrict__ imp,
              uint32_t* __restrict__ out, int Vp, int W) {
  extern __shared__ uint32_t sw[];
  uint32_t* r = sw;            // (Vp, W)
  uint32_t* im = r + Vp * W;   // (Vp, W)
  uint32_t* tb = im + Vp * W;  // (W,) current bitset
  uint32_t* nb = tb + W;       // (W,) next bitset
  const size_t off = static_cast<size_t>(blockIdx.x) * Vp * W;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < Vp * W; i += kThreads) {
    r[i] = route[off + i];
    im[i] = imp[off + i];
  }
  for (int w = threadIdx.x; w < W; w += kThreads) tb[w] = 0u;
  __syncthreads();

  for (int round = 0; round < Vp + 1; ++round) {
    // Vp is a multiple of 32 and kThreads too, so whole warps run each row
    // chunk together and the ballot covers exactly one word.
    for (int p = threadIdx.x; p < Vp; p += kThreads) {
      uint32_t hit = 0u;
      for (int w = 0; w < W; ++w) hit |= im[p * W + w] | (r[p * W + w] & tb[w]);
      const uint32_t bits = __ballot_sync(0xffffffffu, hit != 0u);
      if (lane == 0) nb[p >> 5] = bits;
    }
    __syncthreads();
    int changed = 0;
    for (int w = threadIdx.x; w < W; w += kThreads) changed |= (nb[w] != tb[w]);
    if (!__syncthreads_or(changed)) break;
    for (int w = threadIdx.x; w < W; w += kThreads) tb[w] = nb[w];
    __syncthreads();
  }

  for (int w = threadIdx.x; w < W; w += kThreads) out[static_cast<size_t>(blockIdx.x) * W + w] = tb[w];
}

__global__ void __launch_bounds__(kThreads)
tagged_kernel_global(const uint32_t* __restrict__ route, const uint32_t* __restrict__ imp,
                     uint32_t* __restrict__ out, int Vp, int W) {
  extern __shared__ uint32_t sw[];
  uint32_t* tb = sw;           // (W,) current bitset
  uint32_t* nb = tb + W;       // (W,) next bitset
  const size_t off = static_cast<size_t>(blockIdx.x) * Vp * W;
  const uint32_t* r = route + off;   // (Vp, W), read from global memory
  const uint32_t* im = imp + off;    // (Vp, W)
  const int lane = threadIdx.x & 31;

  for (int w = threadIdx.x; w < W; w += kThreads) tb[w] = 0u;
  __syncthreads();

  for (int round = 0; round < Vp + 1; ++round) {
    for (int p = threadIdx.x; p < Vp; p += kThreads) {
      uint32_t hit = 0u;
      for (int w = 0; w < W; ++w)
        hit |= __ldg(im + static_cast<size_t>(p) * W + w)
               | (__ldg(r + static_cast<size_t>(p) * W + w) & tb[w]);
      const uint32_t bits = __ballot_sync(0xffffffffu, hit != 0u);
      if (lane == 0) nb[p >> 5] = bits;
    }
    __syncthreads();
    int changed = 0;
    for (int w = threadIdx.x; w < W; w += kThreads) changed |= (nb[w] != tb[w]);
    if (!__syncthreads_or(changed)) break;
    for (int w = threadIdx.x; w < W; w += kThreads) tb[w] = nb[w];
    __syncthreads();
  }

  for (int w = threadIdx.x; w < W; w += kThreads) out[static_cast<size_t>(blockIdx.x) * W + w] = tb[w];
}

}  // namespace

extern "C" {

// Shared memory one block needs at Vp padded nodes and W words per row in
// the given variant (0 the word matrices in shared memory, 1 in global).
int repro_tagged_smem_bytes(int Vp, int W, int variant) {
  if (variant == 1) return static_cast<int>(sizeof(uint32_t)) * 2 * W;
  return static_cast<int>(sizeof(uint32_t)) * (2 * Vp * W + 2 * W);
}

// route, imp: (B, Vp, W) 32-bit words; out: (B, W).  Vp % 32 == 0.
// variant 0 (shared memory, Vp <= 960) or 1 (global), as the wrapper's
// tagged_plan picks it.
int repro_tagged(const uint32_t* route, const uint32_t* imp, uint32_t* out,
                 int B, int Vp, int W, int variant, cudaStream_t stream) {
  if (B == 0 || W == 0) return 0;
  if (variant == 1) {
    tagged_kernel_global<<<B, kThreads, repro_tagged_smem_bytes(Vp, W, 1), stream>>>(
        route, imp, out, Vp, W);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = repro_tagged_smem_bytes(Vp, W, 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tagged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tagged_kernel<<<B, kThreads, smem, stream>>>(route, imp, out, Vp, W);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
