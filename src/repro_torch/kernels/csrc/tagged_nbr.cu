// The metro path's blocked node sets in one launch: the neighbor-list
// tagged-node fixed point and the (B, V, V) blocked mask.
//
// Replaces: src/repro/kernels/sparse_solve.py, tagged_nbr, which the
// reference writes as a jnp while-loop (no Pallas kernel) over
//
//     seed[p]   = OR_d route[p, d] & improper[p, d]
//     tagged[p] = seed[p] | OR_d route[p, d] & tagged[nbr[p, d]]
//
// from tagged = seed, one round per step, until a round changes nothing or
// V + 1 rounds ran, on route/improper gathered onto the padded out-neighbor
// lists (V, D) (masked slots false), with the V x V route, worse and
// improper tensors before it and the blocked mask after it (engine.
// blocked_sets) written as separate array operations.  Here, per row batch
// b (member m = b / per), the same fixed point read straight from phi:
//
//     route[p, d]  = mask[p, d] & (phi[b, p, nbr[p, d]] > 0)
//     improper     = route & (pdt[b, nbr[p, d]] > pdt[b, p] + eps)
//     out[b, p, q] = !adj[m, p, q] | (pdt[b, q] > pdt[b, p] + eps) | tagged[q]
//
// with the threshold rounded as one float32 add (__fadd_rn), as PyTorch
// rounds a float32 tensor plus a Python scalar.  The round count (the seed
// counted as round 1, as in the reference) is written beside the flags
// where asked.  The lists are one (V, D) pair for every member
// (nbr_stride 0) or one a member, nbr_stride = V * D entries apart (a
// stacked family whose members' topologies differ): member m reads its
// own, and nothing else of the launch changes.
//
// What bounds it: writing the V x V mask once (1 MB a row batch at metro-sw
// V = 1000; the E = 6400 entries of phi it reads are a hundredth of that).
// The rounds cost a barrier each, a few deep (the routing DAG's depth).
//
// Design (blocked_sets.cuh for the parts shared with tagged.cu): a cluster
// of C CTAs a row batch (one CTA up to V = 128, else a CTA for each 32-row
// word of the bitset, at most 16), each CTA owning 32-row slices.  A thread
// a slot of the CTA's rows reads phi at the listed edge and keeps the
// successor in shared memory where it is routed (-1 elsewhere); a thread a
// row then forms its route bits (one word a row while D <= 32) and seed
// bit.  The fixed point keeps the bitset in every CTA (a thread a row walks
// the set bits of its route word, __ffs); each CTA then writes its rows of
// the mask, comparing pdt as it goes (4 columns a thread, a warp on 128
// consecutive columns): the worse bits of the V^2 pairs are never stored.

#include "blocked_sets.cuh"

namespace {

using blocked::kThreads;

// Shared memory one CTA takes, in 32-bit words, at V nodes, pad width D and
// WR bitset words (32 WR rows) a CTA.
__host__ __device__ inline int smem_words(int V, int D, int WR) {
  const int W = (V + 31) / 32;
  const int WD = (D + 31) / 32;
  return (V + 3) / 4 * 4 + 32 * WR * (WD + D) + WR + 2 * W + 2;
}

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads, 2)
tagged_nbr_mask_kernel(const float* __restrict__ phi, const float* __restrict__ pdt,
                       const uint8_t* __restrict__ adj, const long long* __restrict__ nbr,
                       const uint8_t* __restrict__ nmask, uint8_t* __restrict__ out,
                       uint8_t* __restrict__ tagged_out, int* __restrict__ rounds_out, int V,
                       int D, int per, int WR, float eps, int vec, int nbr_stride) {
  BLOCKED_STAMP(0);
  extern __shared__ uint32_t sw[];
  const int W = (V + 31) >> 5;
  const int WD = (D + 31) >> 5;
  const int Rp = 32 * WR;
  const int rank = blocked::cta_rank<C>();
  const size_t b = blockIdx.x / C;
  const size_t m = b / per;
  const blocked::Rows r = blocked::rows_of(rank, WR, V);

  float* ps = reinterpret_cast<float*>(sw);               // (V,) pdt, 16-byte aligned
  uint32_t* rbits = sw + (V + 3) / 4 * 4;                 // (Rp, WD) route bits by slot
  int* nb = reinterpret_cast<int*>(rbits + Rp * WD);      // (Rp, D) routed successors
  uint32_t* seed = reinterpret_cast<uint32_t*>(nb + Rp * D);   // (WR,)
  uint32_t* T = seed + WR;                                // (2, W) the bitset
  uint32_t* flags = T + 2 * W;                            // (2,) change stamps

  for (int i = threadIdx.x; i < W; i += kThreads) T[i] = 0u;
  if (threadIdx.x < 2) flags[threadIdx.x] = 0u;
  for (int i = threadIdx.x; i < V; i += kThreads) ps[i] = pdt[b * V + i];
  // the edges: a thread a slot of this CTA's rows keeps the slot's
  // successor where the slot is listed and routed (phi > 0), -1 elsewhere
  const float* pb = phi + b * V * V;
  const int slots = r.nrows * D;
  const size_t lst = m * static_cast<size_t>(nbr_stride);
  for (int k = threadIdx.x; k < slots; k += kThreads) {
    const size_t g = lst + static_cast<size_t>(r.row0) * D + k;
    int q = nmask[g] ? static_cast<int>(nbr[g]) : -1;
    if (q >= 0 && !(__ldg(pb + static_cast<size_t>(r.row0 + k / D) * V + q) > 0.f)) q = -1;
    nb[k] = q;
  }
  __syncthreads();
  BLOCKED_STAMP(1);

  // a thread a row: its route bits by slot, and its seed (a routed link to
  // a worse successor), a warp's 32 rows a word
  for (int pl = threadIdx.x; pl < Rp; pl += kThreads) {   // whole warps
    bool improper = false;
    if (pl < r.nrows) {
      const float thr = __fadd_rn(ps[r.row0 + pl], eps);
      for (int wd = 0; wd < WD; ++wd) {
        uint32_t bits = 0u;
        for (int d = 32 * wd; d < min(D, 32 * wd + 32); ++d) {
          const int q = nb[pl * D + d];
          if (q < 0) continue;
          bits |= 1u << (d - 32 * wd);
          improper |= ps[q] > thr;
        }
        rbits[pl * WD + wd] = bits;
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, improper);
    if ((threadIdx.x & 31) == 0) seed[pl >> 5] = word;
  }
  BLOCKED_STAMP(2);
  // every CTA's bits, bitset and stamps are set before any peer's round 1
  blocked::cluster_sync<C>();
  BLOCKED_STAMP(3);

  const int rounds = blocked::fixed_point<C>(
      T, flags, W, r, V + 1, [&](int pl, const uint32_t* cur) -> bool {
        if (pl >= r.nrows) return false;
        if ((seed[pl >> 5] >> (pl & 31)) & 1u) return true;
        for (int wd = 0; wd < WD; ++wd) {
          for (uint32_t bits = rbits[pl * WD + wd]; bits; bits &= bits - 1u) {
            const int q = nb[pl * D + 32 * wd + __ffs(bits) - 1];
            if ((cur[q >> 5] >> (q & 31)) & 1u) return true;
          }
        }
        return false;
      });
  const uint32_t* tf = T + (rounds & 1) * W;
  BLOCKED_STAMP(4);
  BLOCKED_STAMP_VALUE(6, rounds);

  blocked::write_mask_pdt(out + b * V * V, adj + m * V * V, ps, eps, tf, V, r, vec);
  BLOCKED_STAMP_SYNC();
  BLOCKED_STAMP(5);
  if (tagged_out != nullptr) blocked::write_tagged(tagged_out + b * V, tf, r);
  if (rounds_out != nullptr && rank == 0 && threadIdx.x == 0) rounds_out[b] = rounds;
}

template <int C>
int launch(const float* phi, const float* pdt, const uint8_t* adj, const long long* nbr,
           const uint8_t* nmask, uint8_t* out, uint8_t* tagged_out, int* rounds_out, int B,
           int V, int D, int per, int WR, float eps, int vec, int nbr_stride,
           cudaStream_t stream) {
  auto kernel = tagged_nbr_mask_kernel<C>;
  const int smem = static_cast<int>(sizeof(uint32_t)) * smem_words(V, D, WR);
  // the attributes are set once for the largest shared memory asked so far
  static int smem_set = -1;
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && C > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  kernel<<<B * C, kThreads, smem, stream>>>(phi, pdt, adj, nbr, nmask, out, tagged_out,
                                            rounds_out, V, D, per, WR, eps, vec, nbr_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA takes at V nodes, pad width D and WR bitset words a
// CTA.
int repro_tagged_nbr_smem_bytes(int V, int D, int WR) {
  return static_cast<int>(sizeof(uint32_t)) * smem_words(V, D, WR);
}

// phi: (B, V, V) float32; pdt: (B, V) float32; adj: (B / per, V, V) bool;
// nbr: (V, D) int64 and nmask: (V, D) bool, the padded out-neighbor lists,
// with nbr_stride 0, or (B / per, V, D) each, one pair a member, with
// nbr_stride V * D; out: (B, V, V) bool; tagged_out: (B, V) bool or null; rounds_out: (B,)
// int32 or null.  C CTAs a row batch (1, 2, 4, 8 or 16), WR bitset words
// each (C * WR >= ceil(V / 32)); vec 1 where V % 4 == 0 and out and adj are
// 16-byte aligned.
int repro_tagged_nbr(const float* phi, const float* pdt, const uint8_t* adj,
                     const long long* nbr, const uint8_t* nmask, uint8_t* out,
                     uint8_t* tagged_out, int* rounds_out, int B, int V, int D, int per, int C,
                     int WR, float eps, int vec, int nbr_stride, cudaStream_t stream) {
  if (B == 0 || V == 0) return 0;
  if (D < 1 || per < 1 || B % per != 0 || WR < 1 || C * WR < (V + 31) / 32 || nbr_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
#define REPRO_TAGGED_NBR_CASE(c)                                                              \
  case c:                                                                                     \
    return launch<c>(phi, pdt, adj, nbr, nmask, out, tagged_out, rounds_out, B, V, D, per, WR, \
                     eps, vec, nbr_stride, stream);
    REPRO_TAGGED_NBR_CASE(1)
    REPRO_TAGGED_NBR_CASE(2)
    REPRO_TAGGED_NBR_CASE(4)
    REPRO_TAGGED_NBR_CASE(8)
    REPRO_TAGGED_NBR_CASE(16)
#undef REPRO_TAGGED_NBR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
