// Blockwise online-softmax attention forward (causal / sliding window, GQA)
// on the H100's tensor cores (three-term TF32).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd (the
// Pallas _kernel).  For one (batch b, head h, query tile) it walks the key
// tiles of KV head h / (H / KV) and keeps, per query row, the reference
// kernel's float32 running max m (from -1e30), denominator l and output
// accumulator acc:
//
//     s     = (q * scale) k^T, masked entries set to -1e30
//     m_new = max(m, rowmax(s));  alpha = exp(m - m_new)
//     p     = masked ? 0 : exp(s - m_new)
//     l     = l * alpha + rowsum(p);  acc = acc * alpha + p v;  m = m_new
//     out   = acc / max(l, 1e-30)
//
// Masks: key k is in reach of query q when k < seq_len (the true length;
// rows and keys past it are the caller's padding), k <= q if causal, and
// k > q - window if a window is given.  A key tile that is wholly out of
// reach of every row of the query tile (above the causal diagonal, past
// seq_len, before the window) is skipped: in the reference it leaves m, l
// and acc unchanged (alpha = exp(0) = 1, p = 0), so skipping is exact.
//
// What bounds it on the H100: 4 S^2 hd flops per (b, h) for the two
// products (halved by the causal mask) against 4 (2 S hd) bytes per head of
// q, k, v and out, hundreds of flops per byte at S = 2048: bound by
// operations (internlm2-1.8b causal: 68.7 GFLOP, 0.42 ms at 165 TFLOP/s).
//
// Why three-term TF32 and not TF32: the port holds float32 parity with its
// plain version (2e-5 of the largest |value|).  One TF32 product keeps 11
// significant bits (about 3 digits); split every operand x into
// big = tf32(x) (cvt.rna: round to nearest, ties away) and
// small = tf32(x - big) and accumulate small*big + big*small + big*big in
// float32: the dropped small*small term and small's own rounding are
// 2^-22 |x y| each, float32-level (tests/test_torch_tf32x3.py emulates
// both at these contraction lengths).  Three mma per product at TF32's
// 495 TFLOP/s is 165 TFLOP/s of float32-accurate products, against the
// CUDA cores' 67.
//
// Fragment layouts (PTX mma.m16n8k8, .tf32; lane = 4 grp + tig):
//   A (16 x 8, row):  a0 (grp, tig)  a1 (grp + 8, tig)  a2 (grp, tig + 4)
//                     a3 (grp + 8, tig + 4)
//   B (8 x 8, col):   b0 (k = tig, n = grp)  b1 (k = tig + 4, n = grp)
//   C/D (16 x 8):     c0 (grp, 2 tig)  c1 (grp, 2 tig + 1)  c2 (grp + 8, 2 tig)
//                     c3 (grp + 8, 2 tig + 1)
// P V contracts over keys, and a k8 step may order its 8 keys freely as
// long as A and B agree: slot tig <-> key 2 tig, slot tig + 4 <-> key
// 2 tig + 1.  Then the score accumulator of a key tile of 8 is already P's
// A fragment, a = {c0, c2, c1, c3}: no shared-memory stage and no shuffles
// between the two products.
//
// Design: one block of 4 warps per (64-row query tile, h, b), the heaviest
// causal tiles first; each warp owns 16 query rows.  At hd = 64 its query
// fragments are scaled, split and kept in registers for the whole block; at
// hd = 128 they would spill, so the scaled rows wait in shared memory and
// are split at each key tile.  Shared memory holds one key tile and one
// value tile of 64 rows (row stride hd + 4 floats: every fragment read is
// free of bank conflicts), each filled by cp.async (16 bytes) one phase
// ahead: the values of tile j arrive while its scores are multiplied, the
// keys of tile j + 1 while its P V is.  Each product issues its three
// terms term by term over 8 independent accumulators (mma3_row).  Row max
// and sum stay in registers (the 4 lanes of a row reduce with shuffles).
// 101 KB of shared memory at hd = 128 lets two blocks share an SM.  The KV
// head is read in place (no per-head copy of k or v).
//
// On the H100 a three-term product costs 3 mma, 2 shared-memory loads and
// 8 instructions to split its B operand (each warp splits every key and
// value again); scripts/mma_tf32_rate.py measures what such a stream of
// mma.sync reaches, and the kernel runs at about half of it (PERF.md,
// Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query and key tile (BQ = BK)
constexpr int kWarps = 4;        // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kKt = kTile / 8;   // key column tiles of 8 per tile
constexpr float kNegInf = -1e30f;

// Where a warp keeps its scaled query rows: split once, in registers (hd / 2
// registers a thread for each part), or at hd = 128, where those, the
// output accumulators and the scores would take all 255 registers and
// spill, as floats in shared memory, split again at each key tile.
template <int HD>
__host__ __device__ constexpr bool q_in_regs() { return HD <= 64; }

template <int HD>
constexpr int smem_floats() { return (q_in_regs<HD>() ? 2 : 3) * kTile * (HD + 4); }

__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small, each a TF32 value (the tensor core reads the top 19
// bits of an operand, so small needs no mask)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_big(x);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[o + n] += a b[n] for n < K in three terms, small*big, big*small, then
// big*big, issued term by term: consecutive mma are independent, so the
// tensor core's latency is hidden by the other n.
template <int K, int T>
__device__ __forceinline__ void mma3_row(float (&d)[T][4], int o, const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const float (&b)[K][2]) {
  uint32_t bb[K][2], bs[K][2];
#pragma unroll
  for (int n = 0; n < K; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], ab, bb[n][0], bb[n][1]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Start copying a (64, HD) tile from row r0 of a (S, HD) matrix into shared
// memory of row stride HD + 4.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0) {
  constexpr int kLd = HD + 4, kVec = HD / 4;
  const float* s = src + static_cast<size_t>(r0) * HD;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec;
    cp_async16(dst + r * kLd + 4 * c, s + r * HD + 4 * c);
  }
  cp_async_commit();
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             int H, int KV, int S, int seq_len, int causal, int window, float scale) {
  constexpr int kLd = HD + 4, kDk = HD / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // (64, HD + 4) keys of tile j
  float* Vs = Ks + kTile * kLd;          // (64, HD + 4) values of tile j
  float* Qs = Vs + kTile * kLd;          // (64, HD + 4) scaled queries (hd = 128)

  const int nt = S / kTile;
  const int qt = nt - 1 - static_cast<int>(blockIdx.x);   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const size_t head = static_cast<size_t>(S) * HD;
  const float* qb = q + (static_cast<size_t>(b) * H + h) * head;
  const float* kb = k + (static_cast<size_t>(b) * KV + kvh) * head;
  const float* vb = v + (static_cast<size_t>(b) * KV + kvh) * head;
  float* ob = out + (static_cast<size_t>(b) * H + h) * head;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = q0 + 16 * warp + gq;    // this thread's rows r0 and r0 + 8

  // key tiles in reach of some row of this query tile
  int hi = min(nt - 1, (seq_len - 1) / kTile);
  if (causal) hi = min(hi, qt);
  int lo = 0;
  if (window > 0) lo = max(q0 - window + 1, 0) / kTile;
  if (lo <= hi) load_tile<HD>(Ks, kb, lo * kTile);

  // scaled query rows r0, r0 + 8 as A fragments {(r0, 8 d + tq),
  // (r0 + 8, ..), (r0, 8 d + tq + 4), (r0 + 8, ..)}
  constexpr bool kRegs = q_in_regs<HD>();
  uint32_t qB[kRegs ? kDk : 1][4], qS[kRegs ? kDk : 1][4];
  const float* qrow = Qs + (16 * warp + gq) * kLd + tq;
  if constexpr (kRegs) {
    const float* p0 = qb + static_cast<size_t>(r0) * HD + tq;
    const float* p1 = p0 + 8 * HD;
#pragma unroll
    for (int d = 0; d < kDk; ++d) {
      const float x[4] = {p0[8 * d] * scale, p1[8 * d] * scale, p0[8 * d + 4] * scale,
                          p1[8 * d + 4] * scale};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], qB[d][e], qS[d][e]);
    }
  } else {
    const float* src = qb + static_cast<size_t>(q0) * HD;
    for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads)
      Qs[(idx / HD) * kLd + idx % HD] = src[idx] * scale;
    __syncthreads();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDk][4];
#pragma unroll
  for (int d = 0; d < kDk; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

#pragma unroll 1
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kTile;
    load_tile<HD>(Vs, vb, k0);
    cp_async_wait<1>();                  // keys of tile jt
    __syncthreads();

    // s = q k^T: key column tiles of 8, keys k0 + 8 c + 2 tq (+1)
    float s[kKt][4];
#pragma unroll
    for (int c = 0; c < kKt; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
    for (int d = 0; d < kDk; ++d) {
      uint32_t aB[4], aS[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aB[e] = qB[d][e];
          aS[e] = qS[d][e];
        }
      } else {
        const float* p = qrow + 8 * d;
        const float x[4] = {p[0], p[8 * kLd], p[4], p[8 * kLd + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(x[e], aB[e], aS[e]);
      }
      const float* kp = Ks + gq * kLd + 8 * d + tq;
      float kf[kKt][2];
#pragma unroll
      for (int c = 0; c < kKt; ++c) {
        kf[c][0] = kp[8 * c * kLd];
        kf[c][1] = kp[8 * c * kLd + 4];
      }
      mma3_row<kKt>(s, 0, aB, aS, kf);
    }
    __syncthreads();                     // every warp has read the keys
    if (jt < hi) load_tile<HD>(Ks, kb, k0 + kTile);

    // online softmax of rows r0 (s[.][0..1]) and r0 + 8 (s[.][2..3]); a
    // tile wholly in reach of the query tile needs no mask
    const bool full = k0 + kTile <= seq_len && (!causal || k0 + kTile - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + kTile - 1 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKt; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * c + 2 * tq + e;
          const bool ok = full || (kp < seq_len && (!causal || kp <= qp) &&
                                   (window <= 0 || kp > qp - window));
          float& x = s[c][2 * r + e];
          x = ok ? x : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kKt; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * c + 2 * tq + e;
          const bool ok = full || (kp < seq_len && (!causal || kp <= qp) &&
                                   (window <= 0 || kp > qp - window));
          float& x = s[c][2 * r + e];
          x = ok ? expf(x - m_new) : 0.f;
          rs += x;
        }
      l[r] = l[r] * alpha + quad_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < kDk; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }

    if (jt < hi)
      cp_async_wait<1>();                // values of tile jt (the next keys may fly)
    else
      cp_async_wait<0>();
    __syncthreads();

    // acc += p v: key slots {2 tq, 2 tq + 1} of column tile c
#pragma unroll
    for (int c = 0; c < kKt; ++c) {
      uint32_t pB[4], pS[4];
      split(s[c][0], pB[0], pS[0]);
      split(s[c][2], pB[1], pS[1]);
      split(s[c][1], pB[2], pS[2]);
      split(s[c][3], pB[3], pS[3]);
      const float* vp = Vs + (8 * c + 2 * tq) * kLd + gq;
#pragma unroll
      for (int d0 = 0; d0 < kDk; d0 += 8) {            // eight column tiles at a time
        float vf[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          vf[n][0] = vp[8 * (d0 + n)];
          vf[n][1] = vp[kLd + 8 * (d0 + n)];
        }
        mma3_row<8>(acc, d0, pB, pS, vf);
      }
    }
    __syncthreads();                     // every warp has read the values
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
    float* row = ob + static_cast<size_t>(r0 + 8 * r) * HD + 2 * tq;
#pragma unroll
    for (int d = 0; d < kDk; ++d)
      *reinterpret_cast<float2*>(row + 8 * d) =
          make_float2(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int B, int H,
           int KV, int S, int seq_len, int causal, int window, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / kTile, H, B);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, out, H, KV, S, seq_len,
                                                     causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out: (B, H, S, hd); k, v: (B, KV, S, hd); float32, contiguous,
// 16-byte aligned.  S % 64 == 0, hd in {64, 128}, H % KV == 0,
// 0 < seq_len <= S; window <= 0 means none.  Returns a CUDA error code.
int repro_flash_attention(const float* q, const float* k, const float* v, float* out,
                          int B, int H, int KV, int S, int hd, int seq_len, int causal,
                          int window, float scale, cudaStream_t stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (S % kTile || KV <= 0 || H % KV || seq_len <= 0 || seq_len > S)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch<64>(q, k, v, out, B, H, KV, S, seq_len, causal, window, scale, stream);
    case 128: return launch<128>(q, k, v, out, B, H, KV, S, seq_len, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
