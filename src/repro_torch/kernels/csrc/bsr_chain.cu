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
// where one sweep is y = b + sum_d bvals[I, d] @ x[block blk_nbr[I, d]] over
// the nonzero 32 x 32 blocks of the stage matrix only, and any y that is
// non-finite or beyond 1e12 latches at +inf.  For a loop-free strategy the
// stage matrix is nilpotent and the loop settles exactly after (DAG depth
// + 1) sweeps; a loopy ladder candidate runs to the latch or the cap.
//
// What bounds it: every sweep reads the member's NB * BD blocks of the
// stage (2.4 MB at metro-sw V = 1000: NB = 32, BD = 18) and does one
// multiply and one add per block entry, so it is 0.5 flop per byte read
// and bound by bytes; across the sweeps the blocks are re-read from L2,
// but the bound counts each input byte once.  What a member waits on is
// the chain of dependent sweeps (the DAG depth), each one a barrier.
//
// Design: one thread block per member, one warp per block row I (NB warps,
// at most 32; more rows are strided over the warps).  The iterate, the next
// iterate and the right-hand side (Vp = 32 NB floats each, 12 KB at V =
// 1000) and the block list live in shared memory.  Lane l owns row
// I * 32 + l: it reads its row of each block as eight float4 loads and the
// 32 matching x entries as shared-memory broadcasts.  The sum is in a fixed
// order shared with the plain PyTorch version (chain_solve_bsr_plain): the
// 32 products rounded one by one (__fmul_rn), summed by a pairwise tree
// (p[i] += p[i + h] for h = 16, 8, 4, 2, 1), and the block sums added to b
// in block-list order (__fadd_rn, no fused multiply-add).  A sweep is thus
// bit-deterministic, the x == prev exit is exact, and kernel and plain
// version agree bit for bit and run the same number of sweeps.
// __syncthreads_or over the per-row "changed" flags ends the loop.
//
// Padding: rows V..Vp-1 take base = mult = 0, exactly like the reference's
// zero-padded arrays (so 0 * inf = NaN there latches at +inf as it does in
// the reference).  The clamp is written so that NaN propagates as
// jnp.maximum does (fmaxf(NaN, 0) would be 0).

#include <cuda_runtime.h>

namespace {

constexpr int kBs = 32;          // block edge, one row per lane
constexpr int kMaxWarps = 32;
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

__global__ void __launch_bounds__(kMaxWarps * 32)
bsr_chain_kernel(const float* __restrict__ bvals, const long long* __restrict__ blk_nbr,
                 const float* __restrict__ base, const float* __restrict__ mult,
                 float* __restrict__ out, int* __restrict__ sweeps_out,
                 int K, int NB, int BD, int V, int reverse, int clamp) {
  extern __shared__ float s[];
  const int Vp = NB * kBs;
  float* xa = s;                                    // (Vp,) iterate
  float* xb = xa + Vp;                              // (Vp,) next iterate
  float* b = xb + Vp;                               // (Vp,) x_prev, then b
  int* nbr = reinterpret_cast<int*>(b + Vp);        // (NB, BD) block list
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t member = blockIdx.x;
  const int cap = V + 2;

  for (int i = threadIdx.x; i < NB * BD; i += blockDim.x) nbr[i] = static_cast<int>(blk_nbr[i]);
  for (int i = threadIdx.x; i < Vp; i += blockDim.x) b[i] = 0.f;

  for (int step = 0; step < K; ++step) {
    const int k = reverse ? K - 1 - step : step;
    const size_t vo = (member * K + k) * static_cast<size_t>(V);
    const float4* bk = reinterpret_cast<const float4*>(
        bvals + (member * K + k) * static_cast<size_t>(NB) * BD * kBs * kBs);
    __syncthreads();  // the previous stage is done with xa, xb and b
    for (int i = threadIdx.x; i < Vp; i += blockDim.x) {
      const float bs = i < V ? base[vo + i] : 0.f;
      const float ml = i < V ? mult[vo + i] : 0.f;
      b[i] = __fadd_rn(bs, __fmul_rn(ml, b[i]));   // b held x_prev
      xa[i] = 0.f;
    }
    __syncthreads();

    float* x = xa;
    float* y = xb;
    int sweeps = 0;
    for (;;) {
      int changed = 0;
      for (int I = warp; I < NB; I += nwarps) {
        const int r = I * kBs + lane;
        float acc = b[r];
        for (int d = 0; d < BD; ++d) {
          const float* xj = x + nbr[I * BD + d] * kBs;
          const float4* row = bk + (static_cast<size_t>(I * BD + d) * kBs + lane) * (kBs / 4);
          float p[kBs];
#pragma unroll
          for (int q = 0; q < kBs / 4; ++q) {
            const float4 v = __ldg(row + q);
            p[4 * q + 0] = __fmul_rn(v.x, xj[4 * q + 0]);
            p[4 * q + 1] = __fmul_rn(v.y, xj[4 * q + 1]);
            p[4 * q + 2] = __fmul_rn(v.z, xj[4 * q + 2]);
            p[4 * q + 3] = __fmul_rn(v.w, xj[4 * q + 3]);
          }
          acc = __fadd_rn(acc, tree_sum(p));
        }
        acc = latch(acc);
        const float prev = sweeps == 0 ? inf() : x[r];
        changed |= (acc != prev);
        y[r] = acc;
      }
      ++sweeps;
      changed = __syncthreads_or(changed);
      float* t = x;
      x = y;
      y = t;
      if (!changed || sweeps >= cap) break;
    }

    for (int i = threadIdx.x; i < Vp; i += blockDim.x) {
      float v = x[i];
      if (clamp) v = (v != v) ? v : fmaxf(v, 0.f);
      b[i] = v;
      if (i < V) out[vo + i] = v;
    }
    if (threadIdx.x == 0) sweeps_out[member * K + k] = sweeps;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for NB block rows of BD blocks each.
int repro_bsr_chain_smem_bytes(int NB, int BD) {
  return static_cast<int>(sizeof(float)) * (3 * NB * kBs + NB * BD);
}

// bvals: (B, K, NB, BD, 32, 32) float32; blk_nbr: (NB, BD) int64;
// base/mult/out: (B, K, V) float32 with (NB - 1) * 32 < V <= NB * 32;
// sweeps: (B, K) int32.  flags: bit 0 reverse, bit 1 clamp.
int repro_bsr_chain(const float* bvals, const long long* blk_nbr, const float* base,
                    const float* mult, float* out, int* sweeps, int B, int K, int NB,
                    int BD, int V, int flags, cudaStream_t stream) {
  if (B == 0 || K == 0 || NB == 0) return 0;
  const int smem = repro_bsr_chain_smem_bytes(NB, BD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bsr_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = NB < kMaxWarps ? NB : kMaxWarps;
  bsr_chain_kernel<<<B, warps * 32, smem, stream>>>(bvals, blk_nbr, base, mult, out, sweeps,
                                                    K, NB, BD, V, flags & 1, (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
