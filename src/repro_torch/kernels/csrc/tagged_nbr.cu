// Neighbor-list "tagged node" fixed point behind the metro path's blocked
// node sets.
//
// Replaces: src/repro/kernels/sparse_solve.py, tagged_nbr, which the
// reference writes as a jnp while-loop (no Pallas kernel) over
//
//     seed[p]   = OR_d route[p, d] & improper[p, d]
//     tagged[p] = seed[p] | OR_d route[p, d] & tagged[nbr[p, d]]
//
// from tagged = seed, one round per step, until a round changes nothing or
// V + 1 rounds ran.  route/improper are the (V, V) matrices gathered onto
// the padded out-neighbor lists (V, D), masked columns False.  The map is
// monotone, so the early exit lands on the least fixed point, bit-equal to
// the dense V-round sweep and to the bit-packed tagged kernel.
//
// What bounds it: the inputs are two (V, D) bool matrices per member (10 KB
// each at metro-sw V = 1000, D = 10) and a round does a handful of integer
// operations per edge, a few rounds deep (the routing DAG's depth), so the
// bound is reading the bytes once; what a member waits on is the chain of
// dependent rounds, each one a barrier.
//
// Design: one thread block per member.  Each row's route flags are packed
// once into 32-bit words in shared memory (one word a row while D <= 32,
// as at every metro degree), beside the seed and two tagged arrays
// (current and next, one byte a node).  Thread p walks only the set bits of its row's
// route word (__ffs), reading nbr from global memory (L1-resident after the
// first round) and the successor's flag from shared memory.
// __syncthreads_or over the per-row "changed" flags ends the loop.  The
// round count (the seed counted as round 1, as in the reference) is
// written beside the flags.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
tagged_nbr_kernel(const uint8_t* __restrict__ route, const uint8_t* __restrict__ imp,
                  const long long* __restrict__ nbr, uint8_t* __restrict__ out,
                  int* __restrict__ rounds_out, int V, int D) {
  extern __shared__ uint32_t sw[];
  const int WD = (D + 31) / 32;
  uint32_t* rbits = sw;                                          // (V, WD)
  uint8_t* seed = reinterpret_cast<uint8_t*>(rbits + V * WD);    // (V,)
  uint8_t* ta = seed + V;                                        // (V,) tagged
  uint8_t* tb = ta + V;                                          // (V,) next
  const size_t off = static_cast<size_t>(blockIdx.x) * V * D;

  int changed = 0;
  for (int p = threadIdx.x; p < V; p += kThreads) {
    uint8_t s = 0;
    for (int w = 0; w < WD; ++w) {
      uint32_t bits = 0u;
      for (int d = 32 * w; d < D && d < 32 * (w + 1); ++d) {
        const uint8_t r = route[off + static_cast<size_t>(p) * D + d];
        bits |= static_cast<uint32_t>(r != 0) << (d - 32 * w);
        s |= (r != 0) & (imp[off + static_cast<size_t>(p) * D + d] != 0);
      }
      rbits[p * WD + w] = bits;
    }
    seed[p] = s;
    ta[p] = s;
    changed |= s;  // the first test compares the seed with all-false
  }
  changed = __syncthreads_or(changed);

  uint8_t* t = ta;
  uint8_t* tn = tb;
  int rounds = 1;
  while (changed && rounds < V + 1) {
    int ch = 0;
    for (int p = threadIdx.x; p < V; p += kThreads) {
      uint8_t hit = seed[p];
      for (int w = 0; w < WD && !hit; ++w) {
        uint32_t bits = rbits[p * WD + w];
        while (bits && !hit) {
          const int d = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1u;
          hit = t[nbr[static_cast<size_t>(p) * D + d]];
        }
      }
      tn[p] = hit;
      ch |= (hit != t[p]);
    }
    changed = __syncthreads_or(ch);
    uint8_t* tmp = t;
    t = tn;
    tn = tmp;
    ++rounds;
  }

  for (int p = threadIdx.x; p < V; p += kThreads) out[static_cast<size_t>(blockIdx.x) * V + p] = t[p];
  if (threadIdx.x == 0) rounds_out[blockIdx.x] = rounds;
}

}  // namespace

extern "C" {

// Shared memory one block needs at V nodes of pad width D.
int repro_tagged_nbr_smem_bytes(int V, int D) {
  return static_cast<int>(sizeof(uint32_t)) * V * ((D + 31) / 32) + 3 * V;
}

// route, imp: (B, V, D) bool (one byte each); nbr: (V, D) int64;
// out: (B, V) bool; rounds: (B,) int32.
int repro_tagged_nbr(const uint8_t* route, const uint8_t* imp, const long long* nbr,
                     uint8_t* out, int* rounds, int B, int V, int D, cudaStream_t stream) {
  if (B == 0 || V == 0) return 0;
  const int smem = repro_tagged_nbr_smem_bytes(V, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tagged_nbr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tagged_nbr_kernel<<<B, kThreads, smem, stream>>>(route, imp, nbr, out, rounds, V, D);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
