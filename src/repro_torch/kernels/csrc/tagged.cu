// The dense route's blocked node sets in one launch: category 3 ("tagged"
// nodes) and the (B, V, V) blocked mask.
//
// Replaces: src/repro/kernels/blocked_sets.py, tagged_pallas
// (_tagged_kernel), the Pallas kernel that iterates, per (app, stage),
//
//     tagged[p] = OR_q route[p, q] & (improper[p, q] | tagged[q])
//
// on uint32-packed rows until the bitset stops changing, with the packing
// before it and the blocked mask after it (engine.blocked_sets) written as
// separate array operations.  Here, per row batch b (member m = b / per):
//
//     route[p, q]  = phi[b, p, q] > 0                 (NaN and -0.0: false)
//     worse[p, q]  = pdt[b, q] > pdt[b, p] + eps      (one float32 add)
//     improper     = route & worse
//     tagged       = least fixed point of the map above
//     out[b, p, q] = !adj[m, p, q] | worse[p, q] | tagged[q]
//
// (improper is inside worse, so the reference's "| improper" adds nothing.)
// The threshold is __fadd_rn(pdt_p, eps) with eps already a float32: the
// rounding of a float32 tensor plus a Python scalar in PyTorch.
//
// What bounds it: reading phi once (4 V^2 bytes a row batch) and writing
// the mask once (V^2 bytes); adj is read once a member (L2 keeps it for the
// member's other row batches).  The rounds cost a barrier each, a few deep
// (the routing DAG's depth).
//
// Design (blocked_sets.cuh for the parts shared with tagged_nbr.cu): a
// cluster of C CTAs a row batch (one CTA up to V = 128, else a CTA for each
// 32-row word of the bitset, at most 16), two CTAs an SM.  Each CTA forms
// the bits of its own rows on chip.  Where V % 4 == 0 a lane reads 16 bytes
// of a row of phi, its four columns' route bits (phi > 0) make a nibble,
// and an 8-lane group ORs its nibbles into a word by three butterfly
// shuffles: 128 columns a warp instruction, 4 such segments in flight a
// warp; the segment's four worse words (pdt_q > threshold) are ballots over
// pdt in shared memory.  Otherwise a warp reads 32 columns of a row and
// __ballot_sync forms both words.  Route words go to shared memory column
// by column (a thread a row reads them without bank conflicts in the
// rounds), worse words row by row (the mask writer reads a row's
// neighbouring words), and a row with an improper link sets its seed bit.
// No packed word and no intermediate V x V tensor reaches device memory.
// Then the fixed point with the bitset in every CTA (one cluster barrier a
// round), and each CTA writes its rows of the mask.  Where asked, the
// rounds the fixed point ran are written too (rounds_out, a row batch's
// int32; the seed counted as round 1 from an empty bitset, as the
// reference's packed loop counts them): a store of a count the loop keeps
// anyway, nothing else of the launch changes.

#include "blocked_sets.cuh"

namespace {

using blocked::kThreads;
using blocked::kWarps;

constexpr int kUnroll = 4;   // row reads in flight a warp

// Shared memory one CTA takes, in 32-bit words, at V nodes and WR bitset
// words (32 WR rows) a CTA.
__host__ __device__ inline int smem_words(int V, int WR) {
  const int W = (V + 31) / 32;
  return (V + 3) / 4 * 4 + 2 * W * 32 * WR + WR + 2 * W + 2;
}

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads, 2)
tagged_dense_kernel(const float* __restrict__ phi, const float* __restrict__ pdt,
                    const uint8_t* __restrict__ adj, uint8_t* __restrict__ out,
                    uint8_t* __restrict__ tagged_out, int* __restrict__ rounds_out, int V,
                    int per, int WR, float eps, int vec) {
  BLOCKED_STAMP(0);
  extern __shared__ uint32_t sw[];
  const int W = (V + 31) >> 5;
  const int Rp = 32 * WR;
  const size_t b = blockIdx.x / C;
  const size_t m = b / per;
  const int rank = blocked::cta_rank<C>();
  const blocked::Rows r = blocked::rows_of(rank, WR, V);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float* ps = reinterpret_cast<float*>(sw);          // (V,) pdt of the batch, 16-byte aligned
  uint32_t* rw = sw + (V + 3) / 4 * 4;               // (W, Rp) route words, column by column
  uint32_t* ww = rw + W * Rp;                        // (Rp, W) worse words, row by row
  uint32_t* seed = ww + Rp * W;                      // (WR,) rows with an improper link
  uint32_t* T = seed + WR;                           // (2, W) the bitset, double-buffered
  uint32_t* flags = T + 2 * W;                       // (2,) change stamps

  for (int i = threadIdx.x; i < WR; i += kThreads) seed[i] = 0u;
  for (int i = threadIdx.x; i < W; i += kThreads) T[i] = 0u;
  if (threadIdx.x < 2) flags[threadIdx.x] = 0u;
  for (int i = threadIdx.x; i < V; i += kThreads) ps[i] = pdt[b * V + i];
  __syncthreads();
  BLOCKED_STAMP(1);

  const float* pb = phi + b * V * V;
  if (vec) {
    // the bits by 128-column segments of this CTA's rows, kUnroll segments
    // a warp at a time
    const int S = (W + 3) >> 2;
    const int segs = r.nrows * S;
    for (int k0 = warp * kUnroll; k0 < segs; k0 += kWarps * kUnroll) {
      const int pl0 = k0 / S;          // then row and segment step along
      const int s0 = k0 - pl0 * S;
      float4 v[kUnroll];
      int pl = pl0, s = s0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = 128 * s + 4 * lane;
        v[u] = (k0 + u < segs && q < V)
                   ? __ldg(reinterpret_cast<const float4*>(
                         pb + static_cast<size_t>(r.row0 + pl) * V + q))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        if (++s == S) s = 0, ++pl;
      }
      pl = pl0, s = s0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u >= segs) break;   // the same in every lane
        const int q = 128 * s + 4 * lane;
        const float thr = __fadd_rn(ps[r.row0 + pl], eps);
        // V % 4 == 0: a lane's four columns are in or out together
        const uint32_t route = blocked::group_word(q < V ? blocked::nibble_gt(v[u], 0.f) : 0u,
                                                   lane);
        // the worse words by ballot: lane l, word j of the segment, column
        // 32 j + l
        uint32_t worse = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 128 * s + 32 * j + lane;
          const uint32_t word = __ballot_sync(0xffffffffu, c < V && ps[c] > thr);
          if ((lane >> 3) == j) worse = word;
        }
        const int w = 4 * s + (lane >> 3);
        if ((lane & 7) == 0 && w < W) {
          rw[w * Rp + pl] = route;
          ww[pl * W + w] = worse;
          if (route & worse) atomicOr(seed + (pl >> 5), 1u << (pl & 31));
        }
        if (++s == S) s = 0, ++pl;
      }
    }
  } else {
    // a warp a (row, word) pair: 32 consecutive columns, __ballot_sync
    const int pairs = r.nrows * W;
    for (int k0 = warp * kUnroll; k0 < pairs; k0 += kWarps * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u;
        const int pl = k / W;
        const int q = 32 * (k - pl * W) + lane;
        v[u] = (k < pairs && q < V) ? __ldg(pb + static_cast<size_t>(r.row0 + pl) * V + q)
                                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u;
        if (k >= pairs) break;   // the same k in every lane
        const int pl = k / W;
        const int w = k - pl * W;
        const int q = 32 * w + lane;
        const float thr = __fadd_rn(ps[r.row0 + pl], eps);
        const uint32_t route = __ballot_sync(0xffffffffu, v[u] > 0.f);
        const uint32_t worse = __ballot_sync(0xffffffffu, q < V && ps[q] > thr);
        if (lane == 0) {
          rw[w * Rp + pl] = route;
          ww[pl * W + w] = worse;
          if (route & worse) atomicOr(seed + (pl >> 5), 1u << (pl & 31));
        }
      }
    }
  }
  BLOCKED_STAMP(2);
  // every CTA's bits, bitset and stamps are set before any peer's round 1
  blocked::cluster_sync<C>();
  BLOCKED_STAMP(3);

  const int rounds = blocked::fixed_point<C>(
      T, flags, W, r, V + 1, [&](int pl, const uint32_t* cur) -> bool {
        if (pl >= r.nrows) return false;
        if ((seed[pl >> 5] >> (pl & 31)) & 1u) return true;
        for (int w = 0; w < W; ++w)
          if (rw[w * Rp + pl] & cur[w]) return true;
        return false;
      });
  const uint32_t* tf = T + (rounds & 1) * W;
  BLOCKED_STAMP(4);
  BLOCKED_STAMP_VALUE(6, rounds);

  blocked::write_mask(out + b * V * V, adj + m * V * V, ww, tf, V, r, vec);
  BLOCKED_STAMP_SYNC();
  BLOCKED_STAMP(5);
  if (tagged_out != nullptr) blocked::write_tagged(tagged_out + b * V, tf, r);
  if (rounds_out != nullptr && rank == 0 && threadIdx.x == 0) rounds_out[b] = rounds;
}

template <int C>
int launch(const float* phi, const float* pdt, const uint8_t* adj, uint8_t* out,
           uint8_t* tagged_out, int* rounds_out, int B, int V, int per, int WR, float eps,
           int vec, cudaStream_t stream) {
  auto kernel = tagged_dense_kernel<C>;
  const int smem = static_cast<int>(sizeof(uint32_t)) * smem_words(V, WR);
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
  kernel<<<B * C, kThreads, smem, stream>>>(phi, pdt, adj, out, tagged_out, rounds_out, V, per,
                                            WR, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA takes at V nodes and WR bitset words a CTA.
int repro_tagged_dense_smem_bytes(int V, int WR) {
  return static_cast<int>(sizeof(uint32_t)) * smem_words(V, WR);
}

// phi: (B, V, V) float32; pdt: (B, V) float32; adj: (B / per, V, V) bool;
// out: (B, V, V) bool; tagged_out: (B, V) bool or null; rounds_out: (B,)
// int32 or null.  C CTAs a row batch
// (1, 2, 4, 8 or 16), WR bitset words each (C * WR >= ceil(V / 32)); vec 1
// where V % 4 == 0 and phi, out and adj are 16-byte aligned.
int repro_tagged_dense(const float* phi, const float* pdt, const uint8_t* adj, uint8_t* out,
                       uint8_t* tagged_out, int* rounds_out, int B, int V, int per, int C, int WR,
                       float eps, int vec, cudaStream_t stream) {
  if (B == 0 || V == 0) return 0;
  if (per < 1 || B % per != 0 || WR < 1 || C * WR < (V + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
#define REPRO_TAGGED_CASE(c) \
  case c:                    \
    return launch<c>(phi, pdt, adj, out, tagged_out, rounds_out, B, V, per, WR, eps, vec, \
                     stream);
    REPRO_TAGGED_CASE(1)
    REPRO_TAGGED_CASE(2)
    REPRO_TAGGED_CASE(4)
    REPRO_TAGGED_CASE(8)
    REPRO_TAGGED_CASE(16)
#undef REPRO_TAGGED_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
