// Mamba-2 SSD intra-chunk core on the H100's tensor cores (three-term TF32).
//
// Replaces: src/repro/kernels/ssd_chunk.py, ssd_chunk_fwd (the Pallas
// _kernel).  For one (batch * chunk g, head h) with Q = 128 tokens, X (Q, P),
// dt and cum (Q,), and B, C (Q, N) of the head's group h / (H / G):
//
//     w[i, j] = ((C_i . B_j) * exp(cum_i - cum_j)) * dt_j    for j <= i, else 0
//     y       = w @ X                                          (Q, P)
//     state   = sum_j (exp(cum_{Q-1} - cum_j) * dt_j * X_j) (x) B_j, as (P, N)
//
// cum falls along the chunk (dt > 0, A < 0), so exp(cum_i - cum_j)
// overflows to inf above the diagonal; the reference masks that triangle.
// Here the exponential is selected away for j > i, so no 0 * inf arises.
// The state is written directly in the (P, N) order the reference's
// wrapper transposes to.
//
// What bounds it on the H100: per (g, h) about Q^2 P (w X, the triangle)
// + 2 Q N P (the state) flops, and Q^2 N / 2 per (g, group) for C B^T,
// against (Q P + 2 Q) floats read and (Q P + P N) written per head: at
// mamba2-780m's shape (P = 64, N = 128) 9.9 GFLOP against 313 MB, so with
// the products on tensor cores it is bound by bytes (0.094 ms at
// 3.35 TB/s), on the float32 CUDA cores by operations.  At
// jamba-v0.1-52b's (H = 128, P = 64, N = 16) C B^T is two k-steps and the
// state an eighth of the above's a head: 13.2 GFLOP against 580 MB at
// B x nc = 64, bound by bytes on tensor cores (0.17 ms) as well.
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
// The contraction index of a k8 step may be permuted freely as long as A
// and B agree.  The products over j (w X and the state) take slot tig <->
// j = 2 tig and slot tig + 4 <-> j = 2 tig + 1: then an accumulator tile of
// C B^T (rows i, columns j) is already an A fragment of w X, with
// a = {c0, c2, c1, c3}, and no shared-memory round trip is needed.
//
// Design: one block of 8 warps per (chunk, group, tile of heads); the
// launcher picks the tile so that the blocks fill the card in whole waves.
// The block loads B and C of the chunk's group once (cp.async, 16 bytes)
// and each warp forms its rows' lower triangle of C B^T once, in
// registers: warp (rp = warp % 4, ch = warp / 4) owns row blocks rp and
// 7 - rp of 16 rows (18 column tiles of 8 up to the diagonal for every rp,
// so the triangle is balanced) and columns ch * P / 2 .. of y.  Then, per
// head: w from those registers (decay and dt from shared memory), y = w X
// on tensor cores, the state by 8 warps over (P / 16) x (N / 8) tiles with
// A = (X * sdec)^T and B = B from shared memory, split once per block after
// C B^T (big in place, small where C was: every head's state reads it).
// Each product issues its three terms term by term over independent
// accumulators (mma3_row), so no mma waits on the one before.  X, cum and
// dt of the next head are copied with cp.async while the current head is
// multiplied (double buffer; cum and dt are strided by H in memory, so
// they go by 4 bytes).  Shared-memory rows are padded by 4 floats, so
// every fragment read above is free of bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;          // chunk length
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 18;       // C B^T column tiles a warp holds: 2 (rp + 1) + 2 (8 - rp)

template <int P, int N>
struct Layout {
  static constexpr int kLb = N + 4;   // row stride of B and C
  static constexpr int kLx = P + 4;   // row stride of X
  static constexpr int kB = 0;
  static constexpr int kC = kB + kQ * kLb;
  static constexpr int kX = kC + kQ * kLb;            // two buffers
  static constexpr int kCum = kX + 2 * kQ * kLx;      // two buffers
  static constexpr int kDt = kCum + 2 * kQ;           // two buffers
  static constexpr int kFloats = kDt + 2 * kQ;
};

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
// tensor core's latency is hidden by the other n.  b already split.
template <int K, int T>
__device__ __forceinline__ void mma3_row(float (&d)[T][4], int o, const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[K][2],
                                         const uint32_t (&bs)[K][2]) {
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < K; ++n) mma_tf32(d[o + n], ab, bb[n][0], bb[n][1]);
}

// the same, b as floats
template <int K, int T>
__device__ __forceinline__ void mma3_row(float (&d)[T][4], int o, const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const float (&b)[K][2]) {
  uint32_t bb[K][2], bs[K][2];
#pragma unroll
  for (int n = 0; n < K; ++n) {
    split(b[n][0], bb[n][0], bs[n][0]);
    split(b[n][1], bb[n][1], bs[n][1]);
  }
  mma3_row<K>(d, o, ab, as, bb, bs);
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], big[e], small[e]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// X (Q, P), cum and dt (Q,) of head h into buffer `buf`
template <int P, int N>
__device__ __forceinline__ void load_head(float* smem, int buf, const float* __restrict__ xh,
                                          const float* __restrict__ dt,
                                          const float* __restrict__ cum, size_t row0, int h,
                                          int H) {
  using L = Layout<P, N>;
  constexpr int kVec = P / 4;
  float* Xs = smem + L::kX + buf * kQ * L::kLx;
  for (int idx = threadIdx.x; idx < kQ * kVec; idx += kThreads) {
    const int j = idx / kVec, c = idx % kVec;
    cp_async16(Xs + j * L::kLx + 4 * c, xh + ((row0 + j) * H + h) * P + 4 * c);
  }
  const int j = threadIdx.x & (kQ - 1);
  if (threadIdx.x < kQ)
    cp_async4(smem + L::kCum + buf * kQ + j, cum + (row0 + j) * H + h);
  else
    cp_async4(smem + L::kDt + buf * kQ + j, dt + (row0 + j) * H + h);
}

// Accumulator tiles acc[nt] (rows i and i + 8, columns col + 8 nt + 0, 1)
// of head h into y (rows of H heads of P)
template <int P, int kNt>
__device__ __forceinline__ void store_rows(const float (&acc)[kNt][4], float* __restrict__ y,
                                           size_t i, int h, int H, int col) {
  float* o0 = y + (i * H + h) * P + col;
  float* o1 = y + ((i + 8) * H + h) * P + col;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    *reinterpret_cast<float2*>(o0 + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o1 + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ xh, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bc,
                 const float* __restrict__ Cc, float* __restrict__ y,
                 float* __restrict__ state, int H, int G, int tiles, int head_tile) {
  using L = Layout<P, N>;
  constexpr int kLb = L::kLb, kLx = L::kLx;
  constexpr int kNt = P / 16;            // y column tiles of 8 per warp (half of P)
  constexpr int kMb = P / 16;            // state row blocks of 16
  constexpr int kWpm = kWarps / kMb;     // warps per state row block
  constexpr int kSn = N / 8 / kWpm;      // state column tiles per warp
  // every warp writes state tiles, and the warps cover all N / 8 of them
  static_assert(kSn >= 1 && kSn * kWpm == N / 8, "state tiling: take (P, N) with N >= P / 4");
  extern __shared__ __align__(16) float smem[];
  const float* Bs = smem + L::kB;
  const float* Cs = smem + L::kC;

  const int grp = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int g = blockIdx.y;
  const int hpg = H / G;
  const int h0 = grp * hpg + tile * head_tile;
  const int nh = min(head_tile, hpg - tile * head_tile);
  const size_t row0 = static_cast<size_t>(g) * kQ;   // first token of the chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // B and C of the chunk's group, then the first head
  {
    constexpr int kVec = N / 4;
    for (int idx = threadIdx.x; idx < kQ * kVec; idx += kThreads) {
      const int j = idx / kVec, c = idx % kVec;
      const size_t src = ((row0 + j) * G + grp) * N + 4 * c;
      cp_async16(smem + L::kB + j * kLb + 4 * c, Bc + src);
      cp_async16(smem + L::kC + j * kLb + 4 * c, Cc + src);
    }
    cp_async_commit();
    if (nh > 0) load_head<P, N>(smem, 0, xh, dt, cum, row0, h0, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
  }

  // ---- C B^T, this warp's two row blocks, in registers --------------------
  const int rp = warp & 3, ch = warp >> 2;
  const int rbA = rp, rbB = 7 - rp;
  const int na = 2 * (rp + 1);           // slots of row block rbA; the rest are rbB's
  float cb[kSlots][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[s][e] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < N / 8; ++ks) {
    const int n0 = 8 * ks + tq;
    uint32_t aAb[4], aAs[4], aBb[4], aBs[4];
    {
      const float* ca = Cs + (16 * rbA + gq) * kLb + n0;
      const float* cbp = Cs + (16 * rbB + gq) * kLb + n0;
      const float xa[4] = {ca[0], ca[8 * kLb], ca[4], ca[8 * kLb + 4]};
      const float xb[4] = {cbp[0], cbp[8 * kLb], cbp[4], cbp[8 * kLb + 4]};
      split4(xa, aAb, aAs);
      split4(xb, aBb, aBs);
    }
    // six slots at a time, term by term (see mma3_row); a slot's A is
    // row block rbA's or rbB's
    constexpr int kGroup = 6;
#pragma unroll
    for (int s0 = 0; s0 < kSlots; s0 += kGroup) {
      uint32_t bb[kGroup][2], bs[kGroup][2];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const int s = s0 + n, jt = s < na ? s : s - na;
        const float* bp = Bs + (8 * jt + gq) * kLb + n0;
        split(bp[0], bb[n][0], bs[n][0]);
        split(bp[4], bb[n][1], bs[n][1]);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          const bool inA = s0 + n < na;
          uint32_t a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = term == 0 ? (inA ? aAs[e] : aBs[e]) : (inA ? aAb[e] : aBb[e]);
          if (term == 1)
            mma_tf32(cb[s0 + n], a, bs[n][0], bs[n][1]);
          else
            mma_tf32(cb[s0 + n], a, bb[n][0], bb[n][1]);
        }
    }
  }

  // B stays for every head: split it once, big in place and small where C
  // was
  __syncthreads();                       // every warp has read B and C
  {
    uint32_t* Bu = reinterpret_cast<uint32_t*>(smem + L::kB);
    uint32_t* Su = reinterpret_cast<uint32_t*>(smem + L::kC);
    for (int idx = threadIdx.x; idx < kQ * N; idx += kThreads) {
      const int at = (idx / N) * kLb + idx % N;
      split(__uint_as_float(Bu[at]), Bu[at], Su[at]);
    }
  }                                      // (the head loop's barrier orders it)

  // ---- heads ----------------------------------------------------------------
#pragma unroll 1
  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi, buf = hi & 1;
    if (hi + 1 < nh) load_head<P, N>(smem, buf ^ 1, xh, dt, cum, row0, h + 1, H);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Xs = smem + L::kX + buf * kQ * kLx;
    const float* cs = smem + L::kCum + buf * kQ;
    const float* ds = smem + L::kDt + buf * kQ;

    // y = w X: rows of row blocks rbA and rbB, columns ch * P / 2 + 8 nt + ..
    {
      float yA[kNt][4], yB[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yA[nt][e] = yB[nt][e] = 0.f;
      const float cA0 = cs[16 * rbA + gq], cA1 = cs[16 * rbA + gq + 8];
      const float cB0 = cs[16 * rbB + gq], cB1 = cs[16 * rbB + gq + 8];
      const int col0 = ch * (P / 2) + gq;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const bool inA = s < na;
        const int jt = inA ? s : s - na;
        const int rb = inA ? rbA : rbB;
        const int i0 = 16 * rb + gq, i1 = i0 + 8;
        const int j0 = 8 * jt + 2 * tq, j1 = j0 + 1;
        const float ci0 = inA ? cA0 : cB0, ci1 = inA ? cA1 : cB1;
        const float cj0 = cs[j0], cj1 = cs[j1], dj0 = ds[j0], dj1 = ds[j1];
        // A fragment {w(i0, j0), w(i1, j0), w(i0, j1), w(i1, j1)}
        const float w[4] = {
            j0 <= i0 ? (cb[s][0] * expf(ci0 - cj0)) * dj0 : 0.f,
            j0 <= i1 ? (cb[s][2] * expf(ci1 - cj0)) * dj0 : 0.f,
            j1 <= i0 ? (cb[s][1] * expf(ci0 - cj1)) * dj1 : 0.f,
            j1 <= i1 ? (cb[s][3] * expf(ci1 - cj1)) * dj1 : 0.f};
        uint32_t ab[4], as[4];
        split4(w, ab, as);
        const float* xp = Xs + j0 * kLx + col0;
        float b[kNt][2];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          b[nt][0] = xp[8 * nt];
          b[nt][1] = xp[kLx + 8 * nt];
        }
        if (inA)
          mma3_row<kNt>(yA, 0, ab, as, b);
        else
          mma3_row<kNt>(yB, 0, ab, as, b);
      }
      store_rows<P, kNt>(yA, y, row0 + 16 * rbA + gq, h, H, ch * (P / 2) + 2 * tq);
      store_rows<P, kNt>(yB, y, row0 + 16 * rbB + gq, h, H, ch * (P / 2) + 2 * tq);
    }

    // state (P, N) = (X * sdec)^T B: row block mb, column tiles nq * kSn + ..
    {
      const int mb = warp % kMb, nq = warp / kMb;
      float st[kSn][4];
#pragma unroll
      for (int n = 0; n < kSn; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
      const float total = cs[kQ - 1];
      const int p0 = 16 * mb + gq;
#pragma unroll 2
      for (int ks = 0; ks < kQ / 8; ++ks) {
        const int j0 = 8 * ks + 2 * tq, j1 = j0 + 1;
        const float sd0 = expf(total - cs[j0]) * ds[j0];
        const float sd1 = expf(total - cs[j1]) * ds[j1];
        const float* x0 = Xs + j0 * kLx + p0;
        const float* x1 = x0 + kLx;
        // A fragment {A(p0, j0), A(p0 + 8, j0), A(p0, j1), A(p0 + 8, j1)}
        const float a[4] = {x0[0] * sd0, x0[8] * sd0, x1[0] * sd1, x1[8] * sd1};
        uint32_t ab[4], as[4];
        split4(a, ab, as);
        const int at = j0 * kLb + 8 * nq * kSn + gq;
        const uint32_t* bp = reinterpret_cast<const uint32_t*>(Bs) + at;
        const uint32_t* sp = reinterpret_cast<const uint32_t*>(Cs) + at;
        uint32_t bb[kSn][2], bs[kSn][2];
#pragma unroll
        for (int n = 0; n < kSn; ++n) {
          bb[n][0] = bp[8 * n];
          bb[n][1] = bp[kLb + 8 * n];
          bs[n][0] = sp[8 * n];
          bs[n][1] = sp[kLb + 8 * n];
        }
        mma3_row<kSn>(st, 0, ab, as, bb, bs);
      }
      float* out = state + (static_cast<size_t>(g) * H + h) * P * N;
#pragma unroll
      for (int n = 0; n < kSn; ++n) {
        const int col = 8 * (nq * kSn + n) + 2 * tq;
        *reinterpret_cast<float2*>(out + p0 * N + col) = make_float2(st[n][0], st[n][1]);
        *reinterpret_cast<float2*>(out + (p0 + 8) * N + col) = make_float2(st[n][2], st[n][3]);
      }
    }
    __syncthreads();                     // this buffer is refilled two heads on
  }
  cp_async_wait<0>();
}

// Tiles of heads per group: the blocks fill the card in whole waves, each
// block paying C B^T once (about `cb` heads' worth of products).
int pick_tiles(int BNC, int G, int hpg, int slots, double cb) {
  int best = 1;
  double best_cost = 0.0;
  for (int t = 1; t <= hpg; ++t) {
    const int ht = (hpg + t - 1) / t;
    if ((hpg + ht - 1) / ht != t) continue;          // no empty tile
    const long long blocks = static_cast<long long>(BNC) * G * t;
    const long long waves = (blocks + slots - 1) / slots;
    const double cost = static_cast<double>(waves) * (ht + cb);
    if (t == 1 || cost < best_cost) best = t, best_cost = cost;
  }
  return best;
}

template <int P, int N>
int launch(const float* xh, const float* dt, const float* cum, const float* Bc,
           const float* Cc, float* y, float* state, int BNC, int H, int G,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * Layout<P, N>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssd_chunk_kernel<P, N>,
                                                           kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // products per warp: C B^T once a block, y and the state once a head
  const double cb = 54.0 * (N / 8) / (54.0 * (P / 16) + 48.0 * (P * N / 1024));
  const int hpg = H / G;
  const int tiles = pick_tiles(BNC, G, hpg, sms * (per_sm > 0 ? per_sm : 1), cb);
  const int head_tile = (hpg + tiles - 1) / tiles;
  ssd_chunk_kernel<P, N><<<dim3(G * tiles, BNC), kThreads, smem, stream>>>(
      xh, dt, cum, Bc, Cc, y, state, H, G, tiles, head_tile);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_n(int N, const float* xh, const float* dt, const float* cum, const float* Bc,
             const float* Cc, float* y, float* state, int BNC, int H, int G,
             cudaStream_t stream) {
  switch (N) {
    case 16:
      // Jamba's d_state: at P = 32 the state tiling has no column tile a
      // warp (N / 8 = 2 tiles over 4 warps a row block), so P = 64 only
      if constexpr (P == 64)
        return launch<P, 16>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    case 32: return launch<P, 32>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    case 64: return launch<P, 64>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    case 128: return launch<P, 128>(xh, dt, cum, Bc, Cc, y, state, BNC, H, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// xh, y: (BNC, Q, H, P); dt, cum: (BNC, Q, H); Bc, Cc: (BNC, Q, G, N);
// state: (BNC, H, P, N); float32, contiguous; xh, Bc, Cc, y and state
// 16-byte aligned.  Q = 128; (P, N) in {32} x {32, 64, 128} or {64} x
// {16, 32, 64, 128}; H % G == 0.  Returns a CUDA error code.
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
