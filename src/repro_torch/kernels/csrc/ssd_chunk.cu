// Mamba-2 SSD intra-chunk core.
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk_fwd (the Pallas
// _kernel).  For one (batch * chunk g, head h) with Q = 128 tokens, X (Q, P),
// dt and cum (Q,), and B, C (Q, N) of the head's group h / (H / G):
//
//     w[i, j] = ((C_i . B_j) * exp(cum_i - cum_j)) * dt_j    for j <= i, else 0
//     y       = w @ X                                          (Q, P)
//     state   = sum_j (exp(cum_{Q-1} - cum_j) * dt_j * B_j) (x) X_j, as (P, N)
//
// cum falls along the chunk (dt > 0, A < 0), so exp(cum_i - cum_j)
// overflows to inf above the diagonal; the reference masks that triangle
// (by where, or inside the exponent).  Here the exponential is evaluated
// for j <= i only, so no 0 * inf arises.  The state is written directly in
// the (P, N) order the reference's wrapper transposes to.
//
// What bounds it: per (g, h) about Q^2 N + Q^2 P flops for the triangle
// (C B^T and w X) and 2 Q N P for the state, against (Q P + 2 Q + 2 Q N)
// floats read and (Q P + P N) written: tens of flops per byte, so bound by
// operations at the float32 CUDA-core rate (no tensor cores: float32
// parity with the plain version).
//
// Design: one block of 256 threads per (h, g) (heads of one chunk are
// neighbours in the grid and share B and C in L2).  Shared memory holds B
// (Q x N, row stride N + 1), X (Q x P), cum and dt for the whole chunk;
// the Q x Q weight matrix does not fit beside them at N = 128 (64 + 32 +
// 64 KB plus C), so the rows are tiled: for each tile of 32 rows the block
// loads those rows of C and computes their 32 x (i0 + 32) weights, then
// their 32 x P outputs.  Thread (warp r, lane t) owns rows r + 8 a (a < 4)
// against columns t + 32 b: four broadcast reads of C and four
// conflict-free reads of B per four-by-four products.  The state is one
// pass over the chunk with each thread holding a (P / 8) x (N / 32) tile of
// it in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 128;          // chunk length
constexpr int kThreads = 256;
constexpr int kRows = 32;        // rows of the weight matrix per tile
constexpr int kLw = kQ + 1;      // row stride of the weight tile

template <int P, int N>
constexpr int smem_floats() {
  return kQ * (N + 1) + kQ * P + 2 * kQ + kRows * (N + 1) + kRows * kLw;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xh, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bc,
                 const float* __restrict__ Cc, float* __restrict__ y,
                 float* __restrict__ state, int H, int G) {
  constexpr int kLn = N + 1;
  extern __shared__ float smem[];
  float* Bs = smem;                      // (Q, N + 1)
  float* Xs = Bs + kQ * kLn;             // (Q, P)
  float* cs = Xs + kQ * P;               // (Q,) cum
  float* ds = cs + kQ;                   // (Q,) dt
  float* Cs = ds + kQ;                   // (32, N + 1) rows of C
  float* Ws = Cs + kRows * kLn;          // (32, Q + 1) rows of w

  const int h = blockIdx.x, g = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = static_cast<size_t>(g) * kQ;   // first token of the chunk

  for (int idx = tid; idx < kQ * N; idx += kThreads) {
    const int j = idx / N, n = idx % N;
    Bs[j * kLn + n] = Bc[((row0 + j) * G + grp) * N + n];
  }
  for (int idx = tid; idx < kQ * P; idx += kThreads) {
    const int j = idx / P, p = idx % P;
    Xs[j * P + p] = xh[((row0 + j) * H + h) * P + p];
  }
  for (int j = tid; j < kQ; j += kThreads) {
    cs[j] = cum[(row0 + j) * H + h];
    ds[j] = dt[(row0 + j) * H + h];
  }
  __syncthreads();

  // ---- chunk state: thread owns p = warp + 8 a, n = lane + 32 b ----------
  {
    constexpr int kA = P / 8, kB = N / 32;
    float st[kA][kB];
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int b = 0; b < kB; ++b) st[a][b] = 0.f;
    const float total = cs[kQ - 1];
    for (int j = 0; j < kQ; ++j) {
      const float sdec = expf(total - cs[j]) * ds[j];
      float bj[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) bj[b] = Bs[j * kLn + lane + 32 * b] * sdec;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float x = Xs[j * P + warp + 8 * a];
#pragma unroll
        for (int b = 0; b < kB; ++b) st[a][b] = fmaf(bj[b], x, st[a][b]);
      }
    }
    float* out = state + (static_cast<size_t>(g) * H + h) * P * N;
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int b = 0; b < kB; ++b) out[(warp + 8 * a) * N + lane + 32 * b] = st[a][b];
  }

  // ---- y, 32 rows at a time ----------------------------------------------
  for (int i0 = 0; i0 < kQ; i0 += kRows) {
    __syncthreads();                     // previous tile's C and w read
    for (int idx = tid; idx < kRows * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      Cs[r * kLn + n] = Cc[((row0 + i0 + r) * G + grp) * N + n];
    }
    __syncthreads();

    // w[i0 + r, j] for j < i0 + 32: rows warp + 8 a, columns lane + 32 b
    const int ncol = (i0 + kRows) / 32;  // column groups of 32 left of the tile's end
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int n = 0; n < N; ++n) {
      float c[4], bb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) c[a] = Cs[(warp + 8 * a) * kLn + n];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < ncol) bb[b] = Bs[(lane + 32 * b) * kLn + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (b < ncol) acc[a][b] = fmaf(c[a], bb[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = warp + 8 * a, i = i0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= ncol) continue;
        const int j = lane + 32 * b;
        Ws[r * kLw + j] = j <= i ? (acc[a][b] * expf(cs[i] - cs[j])) * ds[j] : 0.f;
      }
    }
    __syncthreads();

    // y[i0 + r, p] = sum_{j < i0 + 32} w[r, j] X[j, p]: rows warp + 8 a,
    // columns lane + 32 b (w is 0 right of the diagonal)
    constexpr int kPb = P / 32;
    float yv[4][kPb];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kPb; ++b) yv[a][b] = 0.f;
    const int jend = i0 + kRows;
    for (int j = 0; j < jend; ++j) {
      float xv[kPb];
#pragma unroll
      for (int b = 0; b < kPb; ++b) xv[b] = Xs[j * P + lane + 32 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float w = Ws[(warp + 8 * a) * kLw + j];
#pragma unroll
        for (int b = 0; b < kPb; ++b) yv[a][b] = fmaf(w, xv[b], yv[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* out = y + ((row0 + i0 + warp + 8 * a) * H + h) * P;
#pragma unroll
      for (int b = 0; b < kPb; ++b) out[lane + 32 * b] = yv[a][b];
    }
  }
}

template <int P, int N>
int launch(const float* xh, const float* dt, const float* cum, const float* Bc,
           const float* Cc, float* y, float* state, int BNC, int H, int G,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<P, N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<P, N><<<dim3(H, BNC), kThreads, smem, stream>>>(
      xh, dt, cum, Bc, Cc, y, state, H, G);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(int N, const float* xh, const float* dt, const float* cum, const float* Bc,
             const float* Cc, float* y, float* state, int BNC, int H, int G,
             cudaStream_t stream) {
  switch (N) {
    case 32: return launch<P, 32>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    case 64: return launch<P, 64>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    case 128: return launch<P, 128>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// xh, y: (BNC, Q, H, P); dt, cum: (BNC, Q, H); Bc, Cc: (BNC, Q, G, N);
// state: (BNC, H, P, N); float32, contiguous.  Q = 128, P in {32, 64},
// N in {32, 64, 128}, H % G == 0.  Returns a CUDA error code.
int repro_ssd_chunk(const float* xh, const float* dt, const float* cum, const float* Bc,
                    const float* Cc, float* y, float* state, int BNC, int H, int G,
                    int P, int N, cudaStream_t stream) {
  if (BNC == 0 || H == 0) return 0;
  if (G <= 0 || H % G) return static_cast<int>(cudaErrorInvalidValue);
  switch (P) {
    case 32: return launch_n<32>(N, xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    case 64: return launch_n<64>(N, xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
