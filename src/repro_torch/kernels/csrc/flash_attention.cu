// Blockwise online-softmax attention forward (causal / sliding window, GQA).
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
// What bounds it: 4 S^2 hd flops per (b, h) for the two products (halved
// by the causal mask) against 4 (2 S hd) bytes per head of q, k, v and
// out, so hundreds of flops per byte at S = 2048: bound by operations, at
// the float32 rate of the CUDA cores (TF32 tensor cores are off for
// parity).
//
// Design: one thread block of 256 threads per (64-row query tile, h, b),
// the heaviest causal tiles first.  Shared memory holds the scaled query
// tile, one key-or-value tile (keys first, then the values of the same
// tile, so 2 tiles rather than 3: 83 KB at hd = 128, which lets two blocks
// share an SM) and the 64 x 64 probabilities.  Thread (ty, tx) of a 16 x 16
// grid owns query rows 4 ty .. 4 ty + 3: it computes their scores against
// keys tx + 16 j (j < 4) with float4 shared-memory reads (row stride hd + 4
// floats: conflict-free), reduces the row max and sum over the 16 lanes of
// its half-warp with shuffles, and accumulates output columns tx + 16 c
// (c < hd / 16) in registers.  The KV head is read in place (no per-head
// copy of k or v).  No tensor cores: float32 parity with the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // query and key tile (BQ = BK)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kLp = kTile + 4;   // row stride of the probability tile

template <int HD>
constexpr int smem_floats() { return 2 * kTile * (HD + 4) + kTile * kLp; }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy a (64, HD) tile starting at row r0 of a (S, HD) matrix into shared
// memory of row stride HD + 4, optionally scaled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, float scale) {
  constexpr int kLd = HD + 4, kVec = HD / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + static_cast<size_t>(r0) * HD);
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec;
    float4 x = s4[static_cast<size_t>(r) * kVec + c];
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(dst + r * kLd + 4 * c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             int H, int KV, int S, int seq_len, int causal, int window, float scale) {
  constexpr int kLd = HD + 4, kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // (64, HD + 4) scaled queries
  float* KVs = Qs + kTile * kLd;         // (64, HD + 4) keys, then values
  float* Ps = KVs + kTile * kLd;         // (64, 68) probabilities

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

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  // key tiles in reach of some row of this query tile
  int hi = min(nt - 1, (seq_len - 1) / kTile);
  if (causal) hi = min(hi, qt);
  int lo = 0;
  if (window > 0) lo = max(q0 - window + 1, 0) / kTile;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  load_tile<HD>(Qs, qb, q0, scale);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();                     // previous tile's values and P read
    load_tile<HD>(KVs, kb, k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < seq_len && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(4 * ty + i) * kLp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                     // keys read, P written
    load_tile<HD>(KVs, vb, k0, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = KVs[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * kLp + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    float* row = ob + static_cast<size_t>(q0 + 4 * ty + i) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + 16 * c] = acc[i][c] / den;
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
