// Blocked-sparse (BSR) fused chain solve of the metro path's stage systems.
//
// Replaces: src/repro/kernels/sparse_solve.py, chain_solve_bsr
// (_bsr_chain_kernel), the Pallas kernel that walks one member's K stages,
// forward in k (or backward with reverse):
//
//     b   = base_k + mult_k * x_prev,           x_prev(start) = 0
//     x   = sweep(0), prev = +inf, i = 1
//     while any(x != prev) and i < V + 2:  prev = x; x = sweep(x); ++i
//     x_k = clamp ? max(x, 0) : x
//
// where one sweep is y = b + sum_d M[I, d] @ x[block blk_nbr[I, d]] over the
// nonzero 32 x 32 blocks of the stage matrix M = Phi_k (trans=0) or Phi_k^T
// (trans=1) only, and any y that is non-finite or beyond 1e12 latches at
// +inf.  For a loop-free strategy the stage matrix is nilpotent and the
// loop settles exactly after (DAG depth + 1) sweeps; a loopy ladder
// candidate runs to the latch or the cap.
//
// What bounds it: the member's unmasked blocks are read once per stage
// (396 blocks, 1.6 MB a stage at metro-sw V = 1000: NB = 32, BD = 18) and
// each sweep does one multiply and one add per block entry, 0.5 flop per
// byte, so the bound is bytes.  What a member waits on is the chain of
// dependent sweeps (the DAG depth), each one a barrier.
//
// What held the earlier design back (as at commit f4ca93a: one 1024-thread
// block per member, a warp per block row; 1.442 ms for the 36-member ladder on an
// NVIDIA H100 80GB HBM3 at 700 W, 27x its bound): every sweep re-read the
// member's whole stage from L2 (about 845 MB over the ladder's 528 sweeps,
// about 0.6 TB/s from 36 SMs), 3 or 36 members kept 3 or 36 of the 132
// SMs busy, and a gather (block_values) wrote and re-read a 175 MB copy of
// the blocks before each launch.
//
// Design, for Hopper: one thread-block cluster per member.
//   * The kernel reads the blocks straight from phi_e (B, K, V, V), the
//     block lists blk_nbr/blk_mask and trans: no gathered copy.  Masked
//     slots are zero blocks and are not read.
//   * The member's NB block rows are split over the cluster's C CTAs
//     (R = ceil(NB / 16) rows each, 2 at metro sizes, and C the power of
//     two at or above ceil(NB / R), at most 16 with the non-portable
//     cluster size).  At the start of each
//     stage a CTA loads its rows' blocks into its own shared memory (each
//     block 32 x 33 floats, column by column: conflict-free for the row
//     reads below, the transpose of trans=1 made on the way in); every
//     sweep of the stage then reads them from there.  Where R x BD blocks
//     do not fit (metro-geant, BD = 27: 228 KB) the same kernel streams
//     them from global memory (L2) every sweep instead: a variant chosen
//     by shape.
//   * Every CTA holds the whole iterate, double-buffered.  A sweep: the
//     CTA's 8 warps form the block sums (lane l owns row l of a block: its
//     32 products against a shared-memory broadcast of x, rounded one by
//     one, and the pairwise tree), then a warp per block row (the 8 warps
//     strided over the rows where a CTA owns more, NB > 128) adds them to
//     b in block-list order, latches, compares and writes each new
//     value into every CTA's next buffer (distributed shared memory).  Each
//     CTA's "changed" flag goes to every CTA the same way, and one cluster
//     barrier (release/acquire) per sweep replaces __syncthreads_or.
//
// Every float operation is the earlier kernel's, in its order: the 32 products
// __fmul_rn, the tree p[i] + p[i + h] for h = 16, 8, 4, 2, 1, the block
// sums added to b in block-list order with __fadd_rn (masked slots as zero
// blocks, as the gathered copy held them), the 1e12 / non-finite latch, the
// V + 2 cap and the NaN-preserving clamp.  So the outputs and the sweep
// counts are bit-equal to the earlier kernel's and to the plain PyTorch version
// (chain_solve_bsr_plain).
//
// Per-member block lists (a stacked family whose members have different
// topologies): row b of the batch reads list b / per, lists_stride ints
// apart; lists_stride 0 is one list for every row, and the launch is then
// the one above, instruction for instruction but the list's offset.
//
// Padding: rows V..Vp-1 take base = mult = 0, exactly like the reference's
// zero-padded arrays (so 0 * inf = NaN there latches at +inf as it does in
// the reference), and the blocks' entries beyond V read as 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBs = 32;          // block edge, one row per lane
constexpr int kLd = kBs + 1;     // a block in shared memory: 32 columns of 33
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr float kDiverge = 1e12f;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// NaN, +-inf and |y| > 1e12 all fail |y| <= 1e12 and latch at +inf.
__device__ __forceinline__ float latch(float y) {
  return fabsf(y) <= kDiverge ? y : inf();
}

// Sum of p[0..31] by halves: p[i] += p[i + 16], then + 8, 4, 2, 1.
__device__ __forceinline__ float tree_sum(float (&p)[kBs]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = __fadd_rn(p[i], p[i + 16]);
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = __fadd_rn(p[i], p[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __fadd_rn(p[i], p[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) p[i] = __fadd_rn(p[i], p[i + 2]);
  return __fadd_rn(p[0], p[1]);
}

// Shared memory of one CTA, in floats (the layout of the kernel below).
__host__ __device__ inline int smem_floats(int NB, int BD, int R, int stream) {
  return (stream ? 0 : R * BD * kBs * kLd) + 2 * NB * kBs + R * kBs + R * BD * kBs
         + 2 * kMaxCluster + 2 * R * BD;
}

// M[I-block row l][J-block column q] of stage matrix `pk` (V x V, row-major),
// zero beyond V.
template <int TRANS>
__device__ __forceinline__ float stage_entry(const float* __restrict__ pk, int V, int I, int J,
                                             int l, int q) {
  const int r = I * kBs + l, c = J * kBs + q;
  if (r >= V || c >= V) return 0.f;
  return TRANS ? __ldg(pk + static_cast<size_t>(c) * V + r)
               : __ldg(pk + static_cast<size_t>(r) * V + c);
}

// C, the cluster size, is a compile-time cluster dimension: the launch is a
// plain <<<>>> launch (the profiler traces it like the other kernels).
template <int TRANS, int STREAM, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(kThreads)
bsr_chain_cluster(const float* __restrict__ phi_e, const long long* __restrict__ blk_nbr,
                  const bool* __restrict__ blk_mask, const float* __restrict__ base,
                  const float* __restrict__ mult, float* __restrict__ out,
                  int* __restrict__ sweeps_out, int K, int NB, int BD, int V, int R,
                  int reverse, int clamp, int per, int lists_stride) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t member = blockIdx.x / C;
  const int row0 = rank * R;                       // this CTA's first block row
  const int rows = max(0, min(R, NB - row0));      // and how many it owns
  const int Vp = NB * kBs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pairs = rows * BD;
  const size_t lst = (member / per) * static_cast<size_t>(lists_stride);

  extern __shared__ float s[];
  float* blocks = s;                                            // (R, BD, 32, 33)
  float* xbuf = blocks + (STREAM ? 0 : R * BD * kBs * kLd);     // (2, Vp) iterate
  float* b = xbuf + 2 * Vp;                                     // (R, 32) x_prev, then b
  float* sums = b + R * kBs;                                    // (R, BD, 32) block sums
  int* flags = reinterpret_cast<int*>(sums + R * BD * kBs);     // (2, 16) changed
  int* nbr = flags + 2 * kMaxCluster;                           // (R, BD) block list
  int* msk = nbr + R * BD;                                      // (R, BD) 1 unmasked

  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int I = row0 + p / BD, d = p % BD;
    nbr[p] = static_cast<int>(blk_nbr[lst + I * BD + d]);
    msk[p] = blk_mask[lst + I * BD + d] ? 1 : 0;
  }
  for (int i = threadIdx.x; i < rows * kBs; i += kThreads) b[i] = 0.f;
  __syncthreads();

  const int cap = V + 2;
  for (int step = 0; step < K; ++step) {
    const int k = reverse ? K - 1 - step : step;
    const size_t vo = (member * K + k) * static_cast<size_t>(V);
    const float* pk = phi_e + (member * K + k) * static_cast<size_t>(V) * V;
    for (int i = threadIdx.x; i < rows * kBs; i += kThreads) {
      const int r = row0 * kBs + i;
      const float bs = r < V ? base[vo + r] : 0.f;
      const float ml = r < V ? mult[vo + r] : 0.f;
      b[i] = __fadd_rn(bs, __fmul_rn(ml, b[i]));   // b held x_prev
    }
    for (int i = threadIdx.x; i < Vp; i += kThreads) xbuf[i] = 0.f;
    if (!STREAM) {
      // the stage's blocks of this CTA's rows, a block per warp: 32
      // independent 128-byte reads of its rows of phi_e (lane = column of
      // phi_e), kept column by column of M
      for (int p = warp; p < pairs; p += kWarps) {
        if (!msk[p]) continue;
        const int I = row0 + p / BD, J = nbr[p];
        float* blk = blocks + static_cast<size_t>(p) * kBs * kLd;
        float v[kBs];
#pragma unroll
        for (int u = 0; u < kBs; ++u)
          v[u] = TRANS ? stage_entry<1>(pk, V, I, J, lane, u) : stage_entry<0>(pk, V, I, J, u, lane);
#pragma unroll
        for (int u = 0; u < kBs; ++u) {
          if (TRANS) blk[u * kLd + lane] = v[u];   // M[lane][u] = Phi[J, u][I, lane]
          else blk[lane * kLd + u] = v[u];         // M[u][lane] = Phi[I, u][J, lane]
        }
      }
    }
    // every CTA's buffers are reset before any peer writes into them
    cluster.sync();

    int cur = 0, sweeps = 0;
    for (;;) {
      const float* x = xbuf + cur * Vp;
      // block sums: lane l owns row l of block (row, d)
      for (int p = warp; p < pairs; p += kWarps) {
        const float* xj = x + nbr[p] * kBs;
        float pr[kBs];
        if (!msk[p]) {
#pragma unroll
          for (int q = 0; q < kBs; ++q) pr[q] = __fmul_rn(0.f, xj[q]);
        } else if (STREAM) {
          const int I = row0 + p / BD, J = nbr[p];
#pragma unroll
          for (int q = 0; q < kBs; ++q) pr[q] = __fmul_rn(stage_entry<TRANS>(pk, V, I, J, lane, q), xj[q]);
        } else {
          const float* blk = blocks + static_cast<size_t>(p) * kBs * kLd;
#pragma unroll
          for (int q = 0; q < kBs; ++q) pr[q] = __fmul_rn(blk[q * kLd + lane], xj[q]);
        }
        sums[p * kBs + lane] = tree_sum(pr);
      }
      __syncthreads();
      // a warp per block row (strided where a CTA owns more than 8): b
      // plus the block sums in block-list order
      int changed = 0;
      for (int w = warp; w < rows; w += kWarps) {
        const int r = (row0 + w) * kBs + lane;
        float acc = b[w * kBs + lane];
        for (int d = 0; d < BD; ++d) acc = __fadd_rn(acc, sums[(w * BD + d) * kBs + lane]);
        acc = latch(acc);
        const float prev = sweeps == 0 ? inf() : x[r];
        changed |= acc != prev;
        const int nxt = (cur ^ 1) * Vp + r;
        for (int c = 0; c < C; ++c) *cluster.map_shared_rank(xbuf + nxt, c) = acc;
      }
      changed = __syncthreads_or(changed);
      if (threadIdx.x < C)
        *cluster.map_shared_rank(flags + (sweeps & 1) * kMaxCluster + rank, threadIdx.x) = changed;
      cluster.sync();
      int any = 0;
      for (int c = 0; c < C; ++c) any |= flags[(sweeps & 1) * kMaxCluster + c];
      ++sweeps;
      cur ^= 1;
      if (!any || sweeps >= cap) break;
    }

    const float* x = xbuf + cur * Vp;
    for (int i = threadIdx.x; i < rows * kBs; i += kThreads) {
      const int r = row0 * kBs + i;
      float v = x[r];
      if (clamp) v = (v != v) ? v : fmaxf(v, 0.f);
      b[i] = v;
      if (r < V) out[vo + r] = v;
    }
    if (rank == 0 && threadIdx.x == 0) sweeps_out[member * K + k] = sweeps;
    // no CTA resets its buffers for the next stage while a peer still reads
    cluster.sync();
  }
}

template <int TRANS, int STREAM, int C>
int launch(const float* phi_e, const long long* blk_nbr, const bool* blk_mask,
           const float* base, const float* mult, float* out, int* sweeps, int B, int K,
           int NB, int BD, int V, int R, int reverse, int clamp, int per, int lists_stride,
           cudaStream_t stream) {
  auto kernel = bsr_chain_cluster<TRANS, STREAM, C>;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(NB, BD, R, STREAM);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * C, kThreads, smem, stream>>>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, K,
                                            NB, BD, V, R, reverse, clamp, per, lists_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int TRANS, int STREAM>
int launch_c(const float* phi_e, const long long* blk_nbr, const bool* blk_mask,
             const float* base, const float* mult, float* out, int* sweeps, int B, int K,
             int NB, int BD, int V, int C, int R, int reverse, int clamp, int per,
             int lists_stride, cudaStream_t stream) {
  switch (C) {
#define REPRO_BSR_CASE(c)                                                                   \
  case c:                                                                                   \
    return launch<TRANS, STREAM, c>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, B, K, \
                                    NB, BD, V, R, reverse, clamp, per, lists_stride, stream);
    REPRO_BSR_CASE(1)
    REPRO_BSR_CASE(2)
    REPRO_BSR_CASE(4)
    REPRO_BSR_CASE(8)
    REPRO_BSR_CASE(16)
#undef REPRO_BSR_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs: NB block rows of BD blocks, R rows a CTA,
// stream 0 (the CTA's blocks in shared memory) or 1 (read from global).
int repro_bsr_chain_smem_bytes(int NB, int BD, int R, int stream) {
  return static_cast<int>(sizeof(float)) * smem_floats(NB, BD, R, stream);
}

// The number of 16-CTA clusters (R rows each, the given variant) the card
// can hold at once; 0 where one does not fit.
int repro_bsr_chain_max_clusters(int NB, int BD, int R, int stream, int* out) {
  auto kernel = stream ? bsr_chain_cluster<0, 1, 16> : bsr_chain_cluster<0, 0, 16>;
  const int smem = repro_bsr_chain_smem_bytes(NB, BD, R, stream);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// phi_e: (B, K, V, V) float32; blk_nbr: (B / per, NB, BD) int64 and
// blk_mask: (B / per, NB, BD) bool, lists_stride = NB * BD (one list a
// member of per rows), or (NB, BD) each with lists_stride 0 (one list for
// all); base/mult/out: (B, K, V) float32 with (NB - 1) * 32 < V <= NB * 32;
// sweeps: (B, K) int32.  flags: bit 0 reverse, bit 1 clamp, bit 2 trans.
// C CTAs a cluster (1, 2, 4, 8 or 16), R block rows each (R * C >= NB); stream
// as the wrapper's bsr_chain_plan picks them.
int repro_bsr_chain(const float* phi_e, const long long* blk_nbr, const bool* blk_mask,
                    const float* base, const float* mult, float* out, int* sweeps, int B,
                    int K, int NB, int BD, int V, int C, int R, int stream, int flags, int per,
                    int lists_stride, cudaStream_t cuda_stream) {
  if (B == 0 || K == 0 || NB == 0) return 0;
  if (C < 1 || C > kMaxCluster || R * C < NB || per < 1 || B % per != 0 || lists_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int reverse = flags & 1, clamp = (flags >> 1) & 1, trans = (flags >> 2) & 1;
  if (trans) {
    return stream ? launch_c<1, 1>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, B, K, NB,
                                   BD, V, C, R, reverse, clamp, per, lists_stride, cuda_stream)
                  : launch_c<1, 0>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, B, K, NB,
                                   BD, V, C, R, reverse, clamp, per, lists_stride, cuda_stream);
  }
  return stream ? launch_c<0, 1>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, B, K, NB, BD,
                                 V, C, R, reverse, clamp, per, lists_stride, cuda_stream)
                : launch_c<0, 0>(phi_e, blk_nbr, blk_mask, base, mult, out, sweeps, B, K, NB, BD,
                                 V, C, R, reverse, clamp, per, lists_stride, cuda_stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
