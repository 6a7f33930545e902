// Fused chain solve over a stack of packed LU factors.
//
// Replaces: src/repro/kernels/batched_solve.py, chain_solve
// (_chain_solve_kernel + _two_sweep), the Pallas kernel that walks one
// member's K stages inside one kernel invocation:
//
//     x_k = A_k^{-1(T)} (base_k + mult_k * x_prev),   x_prev(start) = 0,
//
// forward in k, or backward with reverse; trans=1 solves the transposed
// system from the same factors; clamp keeps x >= 0 (NaN stays NaN).
//
// What bounds it: each stage reads a V x V factor once and does 2 V^2
// flops with it (two triangular sweeps), 0.5 flop per byte, so the bound
// is device-memory traffic: 0.0133 ms for the sw-queue ladder's 360 chains
// of K = 3 stages at V = 100, 0.0011 ms for the 30 chains of the traffic
// and marginal sweeps.  But a chain is 2 K V dependent row steps, so what
// a launch waits on is the latency of one row step times 2 K V.
//
// What held the earlier design back (PR 14: one 128-thread block per chain,
// warp 0 running two_sweep.cuh while three warps idle; 0.285 ms for 360
// chains, 0.249 for 30 with trans=1, 0.213 for the 30 marginal ones, on an
// NVIDIA H100 80GB HBM3 at 700 W): per row, a lane-strided dot product
// reading y from shared memory, a five-level __shfl_xor tree, lane 0's
// subtraction and division, a store to shared memory and a __syncwarp,
// and the next row read that store back, all on the critical path; 360
// chains took no longer than 30.  Each stage's factor load waited behind
// the previous stage.
//
// Design, one 128-thread block per chain as before, with the same float
// operations in the same order (each lane sums its terms in ascending j
// with one FMA each from 0; the xor tree 16, 8, 4, 2, 1; the subtraction
// and the IEEE division), so the results are bit-equal to PR 14's:
//   * the tree without shuffles on the critical path: a row's partials
//     except the one lane that adds the newest y are known a row early.
//     They are gathered through shared memory in the row before (gather()
//     below), every lane forms the five subtree sums the butterfly joins to
//     the late lane's partial, and the row's sum is the newest FMA and five
//     dependent adds; every lane then has the same y_i, so nothing is stored
//     and read back between rows;
//   * the forward sweep keeps y in registers (lane l holds y_j for
//     j = l mod 32, NC = ceil(V / 32) a template parameter) and walks its
//     factor operands by pointer; the backward sweep's lanes take
//     j = i+1+l mod 32, which moves with i, so it reads older y from shared
//     memory, y_{i+1} from a register;
//   * trans is a template parameter of the sweeps, so each loop is one
//     straight run of instructions;
//   * the factor is loaded with 16-byte reads where V is a multiple of 4
//     (cp.async otherwise), and while warp 0 sweeps stage k the three other
//     warps prefetch stage k+1's factor into L2.  A second shared buffer
//     would overlap the copy itself, but two 40 KB buffers allow 2 blocks
//     per SM, 264 slots, fewer than the ladder's 360 chains: a second wave.
// Shared memory: the factor (V x (V | 1): the odd stride keeps the column
// reads of trans=1 on distinct banks), the right-hand side, the iterate
// and 2 x 32 floats for the gathered partials, which caps V at 239.
//
// Design, 239 < V <= 2048 (the dense route at metro sizes: V = 300, 600
// and 1000 in benchmarks/gp_scaling.py): the factor no longer fits one
// block's shared memory and stays in global memory (L2).  The earlier design
// (as at commit 8ee676d: one 256-thread block per chain running both sweeps
// by strips of 32 rows, strip_sweep.cuh; 0.377 / 0.988 / 2.071 ms for the
// ladder's 36 chains at V = 300 / 600 / 1000 on an NVIDIA H100 80GB HBM3 at
// 700 W) kept 36 of 132 SMs busy and ran every strip step in series: the
// diagonal block read from L2, warp 0's 32-step solve while 7 warps
// waited, then the off-diagonal update, nothing of the next strip in
// flight.
//
// Design: a thread-block cluster of C CTAs of 8 warps per chain (C the least
// power of two from 2 that gives every 32-row strip a warp: 2 at V = 300, 4
// at 600 and 1000, 8 up to 2048).  Warp w of CTA r owns strip r + C w: it
// alone holds that strip's iterate (a register a lane), applies every other
// strip's solved values to it, and solves its diagonal block (kept in
// registers, a stage at a time) forward and backward in every stage.  The
// steps of a chain (per stage: forward over strips 0 .. ns-1, backward over
// ns-1 .. 0) each solve one strip; its 32 values go into every CTA's
// shared memory (distributed shared memory, a buffer per stage parity) and
// one cluster barrier phase per step publishes them.  The warp that solves
// the next step's strip applies this step to it first (look-ahead) and
// arrives after publishing; every other thread arrives at once and then
// applies the step to its own strip, the operands of its next update
// already read into registers.  The operations, in strip_sweep.cuh's
// order:
//   * trans=1, the column form: each column's 32-term sum over a solved
//     strip, fused multiply-adds from 0 in ascending row, subtracted once;
//   * trans=0 forward, the row form: each lane's one term per earlier strip
//     (its partial, in ascending strip order, known a strip early), the
//     partials to the row's lane through shared memory and summed as
//     strip_warp_sum's butterfly does;
//   * trans=0 backward: a row's terms run newest strip first, so its sums
//     are formed when the strip after it is solved, by all 8 warps of the
//     owning CTA (4 rows each), with the butterfly;
//   * the diagonal solve: strip_diag_solve's column steps, the IEEE division
//     for U's pivots (a zero dividend takes its signed zero directly:
//     ieee_div below).
// So the iterates are bit-equal to the earlier strips'.  Above V = 2048 the
// earlier strips (one block a chain) run.
//
// Identity row permutation assumed (the unpivoted factors of batched_lu.cu).
// IEEE division; the clamp is written so that NaN propagates as
// jnp.maximum(nan, 0) does (fmaxf alone would return 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "strip_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;   // V <= 256 (shared memory caps it at 239)
constexpr int kWarpsStrip = repro::kStripWarps;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The xor tree's node over slots {s ^ (offsets 2h .. 16)} of x, as the
// butterfly forms it (float addition is commutative, so each pair's order
// does not matter): Node<32, s> is x[s], Node<h, s> adds the two halves.
template <int H, int S>
struct Node {
  static __device__ __forceinline__ float sum(const float* x) {
    return Node<2 * H, S>::sum(x) + Node<2 * H, (S ^ H)>::sum(x);
  }
};
template <int S>
struct Node<32, S> {
  static __device__ __forceinline__ float sum(const float* x) { return x[S]; }
};

// A row's 32 lane partials without its newest term, gathered for the tree.
// Lane l stores its partial in slot l ^ o, o the lane that will add the
// newest term, so slot 0 is o's partial and the subtrees the butterfly
// joins to it, offsets 16, 8, 4, 2, 1, are fixed slot sets.  Every lane
// reads all 32 slots and forms the same five subtree sums: the row's sum
// is then ((((x_o + a16) + a8) + a4) + a2) + a1, the butterfly's own
// result, five dependent adds after the newest term instead of five
// shuffle-and-add levels.
struct Gathered {
  float x0, a16, a8, a4, a2, a1;
};

__device__ __forceinline__ Gathered gather(float* red, float partial, int lane, int o) {
  red[lane ^ o] = partial;
  __syncwarp();
  float x[32];
  const float4* r4 = reinterpret_cast<const float4*>(red);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float4 w = r4[t];
    x[4 * t] = w.x;
    x[4 * t + 1] = w.y;
    x[4 * t + 2] = w.z;
    x[4 * t + 3] = w.w;
  }
  return {x[0], Node<32, 16>::sum(x), Node<16, 8>::sum(x), Node<8, 4>::sum(x),
          Node<4, 2>::sum(x), Node<2, 1>::sum(x)};
}

__device__ __forceinline__ float tree_sum(float xo, const Gathered& g) {
  return ((((xo + g.a16) + g.a8) + g.a4) + g.a2) + g.a1;
}

// Forward sweep (unit-lower L for TR=0, U^T with its diagonal for TR=1)
// on y in place; the result is in y on return (after __syncwarp).
template <int NC, int TR>
__device__ __forceinline__ void forward_sweep(const float* m, int ld, float* y, int V, int lane,
                                              float* red) {
  float yv[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) yv[t] = 0.f;
  Gathered g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // row 0 has no terms
  float mlast = 0.f;   // this row's entry at column i-1 (the newest term)
  float ylast = 0.f;   // y_{i-1}
  float b = y[0];
  float d = m[0];
  const int step = TR ? 1 : ld;
  const float* pm[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    const int jc = min(32 * t + lane, V - 1);
    pm[t] = TR ? m + jc * ld + 1 : m + ld + jc;
  }
  const float* pmn = TR ? m + 1 : m + ld;   // M(n, i)
  const float* pdn = m + ld + 1;            // M(n, n)
  const float* pbn = y + 1;                 // y[n]
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    for (int r = 0; r < 32; ++r) {
      const int i = 32 * c + r;
      if (i >= V) break;
      float mv[NC];
#pragma unroll
      for (int t = 0; t <= c; ++t) mv[t] = *pm[t];
      const float mn = *pmn, dn = *pdn, bn = *pbn;
      // the critical path: the newest term, the tree's five adds
      const float xo = i > 0 ? fmaf(mlast, ylast, g.x0) : g.x0;
      const float acc = tree_sum(xo, g);
      // off it: row i+1's partials without y_i, gathered
      float pn = 0.f;
#pragma unroll
      for (int t = 0; t <= c; ++t) pn = (t < c || lane < r) ? fmaf(mv[t], yv[t], pn) : pn;
      g = gather(red + ((i & 1) << 5), pn, lane, i & 31);
      const float yi = TR ? (b - acc) / d : b - acc;
      if (lane == r) yv[c] = yi;
#pragma unroll
      for (int t = 0; t < NC; ++t) pm[t] += step;
      pmn += ld + 1;
      pdn += ld + 1;
      pbn += 1;
      mlast = mn;
      ylast = yi;
      b = bn;
      d = dn;
    }
  }
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    const int j = 32 * t + lane;
    if (j < V) y[j] = yv[t];
  }
  __syncwarp();
}

// Backward sweep (U with its diagonal for TR=0, unit-upper L^T for TR=1)
// on y in place.
template <int NC, int TR>
__device__ __forceinline__ void backward_sweep(const float* m, int ld, float* y, int V, int lane,
                                               float* red) {
  Gathered g = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // row V-1 has no terms
  float ylast = 0.f;     // y_{i+1}
  float m0 = 0.f;        // lane 0's operands for this row: M(i, i+1+32t),
  float ml[NC], yl[NC];  // and y_{i+1+32t} for t >= 1
#pragma unroll
  for (int t = 0; t < NC; ++t) ml[t] = yl[t] = 0.f;
  float b = y[V - 1];
  float d = m[(V - 1) * ld + V - 1];
  for (int i = V - 1; i >= 0; --i) {
    const int n = max(i - 1, 0);
    float mv[NC], yw[NC], m0n, mln[NC], yln[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int jc = min(i + lane + 32 * t, V - 1);
      mv[t] = TR ? m[jc * ld + n] : m[n * ld + jc];
      yw[t] = (lane == 1 && t == 0) ? ylast : y[jc];
      const int j0 = min(i + 32 * t, V - 1);
      mln[t] = TR ? m[j0 * ld + n] : m[n * ld + j0];
      yln[t] = y[j0];
    }
    m0n = mln[0];
    const float bn = y[n];
    const float dn = m[n * ld + n];
    // the critical path: lane 0's terms, newest first, the tree's five adds
    float a0 = (i + 1 < V) ? fmaf(m0, ylast, 0.f) : 0.f;
#pragma unroll
    for (int t = 1; t < NC; ++t) a0 = (i + 1 + 32 * t < V) ? fmaf(ml[t], yl[t], a0) : a0;
    const float acc = tree_sum(a0, g);
    // off it: row i-1's partials of lanes >= 1, gathered
    float pn = 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) pn = (i + lane + 32 * t < V) ? fmaf(mv[t], yw[t], pn) : pn;
    g = gather(red + ((i & 1) << 5), pn, lane, 0);
    const float yi = TR ? b - acc : (b - acc) / d;
    y[i] = yi;    // read two rows on, after the next row's gather barrier
    m0 = m0n;
#pragma unroll
    for (int t = 1; t < NC; ++t) {
      ml[t] = mln[t];
      yl[t] = yln[t];
    }
    ylast = yi;
    b = bn;
    d = dn;
  }
  __syncwarp();
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
chain_kernel_pipelined(const float* __restrict__ lu, const float* __restrict__ base,
                       const float* __restrict__ mult, float* __restrict__ x_out,
                       int K, int V, int ld, int trans, int reverse, int clamp, int vec) {
  extern __shared__ float s[];
  float* red = s;           // (2, 32) the sweeps' gathered partials
  float* m = s + 64;        // (V, ld) factor of the current stage
  float* y = m + V * ld;    // (V,) right-hand side, solved in place
  float* xv = y + V;        // (V,) x_prev, then this stage's solution
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t chain = blockIdx.x;
  const size_t vv = static_cast<size_t>(V) * V;

  for (int i = threadIdx.x; i < V; i += kThreads) xv[i] = 0.f;

  for (int step = 0; step < K; ++step) {
    const int k = reverse ? K - 1 - step : step;
    const size_t mo = (chain * K + k) * vv;
    const size_t vo = (chain * K + k) * static_cast<size_t>(V);
    __syncthreads();  // the previous stage is done with m, xv and y
    if (vec) {
      // rows of V/4 float4s: 16-byte reads, scalar stores to the odd stride
      const float4* src = reinterpret_cast<const float4*>(lu + mo);
      const int V4 = V >> 2;
#pragma unroll 4
      for (int e = threadIdx.x; e < V * V4; e += kThreads) {
        const int i = e / V4, j = (e - i * V4) << 2;
        const float4 w = src[e];
        float* dst = m + i * ld + j;
        dst[0] = w.x;
        dst[1] = w.y;
        dst[2] = w.z;
        dst[3] = w.w;
      }
    } else {
      for (int i = warp; i < V; i += kWarps)
        for (int j = lane; j < V; j += 32)
          cp_async4(m + i * ld + j, lu + mo + static_cast<size_t>(i) * V + j);
    }
    for (int i = threadIdx.x; i < V; i += kThreads) y[i] = base[vo + i] + mult[vo + i] * xv[i];
    cp_async_wait_all();
    __syncthreads();

    if (warp == 0) {
      if (trans) {
        forward_sweep<NC, 1>(m, ld, y, V, lane, red);
        backward_sweep<NC, 1>(m, ld, y, V, lane, red);
      } else {
        forward_sweep<NC, 0>(m, ld, y, V, lane, red);
        backward_sweep<NC, 0>(m, ld, y, V, lane, red);
      }
      for (int i = lane; i < V; i += 32) {
        float v = y[i];
        if (clamp) v = (v != v) ? v : fmaxf(v, 0.f);
        xv[i] = v;
        x_out[vo + i] = v;
      }
    } else if (step + 1 < K) {
      const int kn = reverse ? k - 1 : k + 1;
      const float* next = lu + (chain * K + kn) * vv;
      for (size_t o = static_cast<size_t>(threadIdx.x - 32) * 32; o < vv;
           o += static_cast<size_t>(kThreads - 32) * 32)
        prefetch_l2(next + o);
    }
  }
}

__global__ void __launch_bounds__(repro::kStripThreads)
chain_kernel_strips(const float* __restrict__ lu, const float* __restrict__ base,
                    const float* __restrict__ mult, float* __restrict__ x_out,
                    int K, int V, int trans, int reverse, int clamp) {
  extern __shared__ float s[];
  float* y = s;                       // (V,) right-hand side, solved in place
  float* xv = y + V;                  // (V,) x_prev, then this stage's solution
  float* tile = xv + V;               // (32, 33) a strip's diagonal block
  const size_t chain = blockIdx.x;
  const size_t vv = static_cast<size_t>(V) * V;

  for (int i = threadIdx.x; i < V; i += blockDim.x) xv[i] = 0.f;
  for (int step = 0; step < K; ++step) {
    const int k = reverse ? K - 1 - step : step;
    const size_t vo = (chain * K + k) * static_cast<size_t>(V);
    __syncthreads();  // the previous stage is done with xv and y
    for (int i = threadIdx.x; i < V; i += blockDim.x) y[i] = base[vo + i] + mult[vo + i] * xv[i];
    __syncthreads();
    repro::strip_two_sweep(lu + (chain * K + k) * vv, V, y, trans, tile);
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      float v = y[i];
      if (clamp) v = (v != v) ? v : fmaxf(v, 0.f);
      xv[i] = v;
      x_out[vo + i] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 239 < V <= 2048: a thread-block cluster per chain, a warp per strip
// ---------------------------------------------------------------------------

constexpr int kStrip = repro::kStrip;
constexpr int kMaxStripCluster = 8;
constexpr int kTbufFloats = kStrip * (kStrip + 1);   // a warp's partials, transposed

// CTAs a cluster: every warp owns at most one 32-row strip.
__host__ __device__ inline int chain_cluster_size(int V) {
  const int ns = (V + kStrip - 1) / kStrip;
  int c = 2;
  while (c * kWarpsStrip < ns) c *= 2;
  return c;
}

__host__ __device__ inline int chain_cluster_smem_floats(int V) {
  return 2 * V + kStrip + kWarpsStrip * kTbufFloats;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x / d, IEEE, as strip_diag_solve divides; a zero x over a finite nonzero
// d is the signed zero x * d without the division, whose range check sends
// a zero dividend (common in the metro ladder's sparse right-hand sides) to
// its slow path.
__device__ __forceinline__ float ieee_div(float x, float d) {
  if (x == 0.f && isfinite(d) && d != 0.f) return x * d;
  return x / d;
}

// The butterfly of strip_sweep.cuh's strip_warp_sum (v += shfl_xor(v, o),
// o = 16 .. 1: every lane ends with the same sum) on 32 values held by one
// thread, p[i] + p[i + 16] already formed: then + 8, 4, 2, 1.
__device__ __forceinline__ float butterfly_sum(float (&p)[kStrip / 2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = p[i] + p[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = p[i] + p[i + 4];
#pragma unroll
  for (int i = 0; i < 2; ++i) p[i] = p[i] + p[i + 2];
  return p[0] + p[1];
}

// Step t of a chain's sweeps: stage st (its k in order), forward (F) over
// strips 0 .. ns-1, then backward (B) over ns-1 .. 0.
struct Step {
  int st, fwd, s;
};

__device__ __forceinline__ Step step_of(int t, int ns) {
  const int w = t % (2 * ns);
  return {t / (2 * ns), w < ns, w < ns ? w : 2 * ns - 1 - w};
}

// Does step u's solved strip update strip sm of its sweep?  Column form
// (TR=1): the strips after it (F) or before it (B); row form (TR=0): the
// partial sums of the strips after it (F) only.
template <int TR>
__device__ __forceinline__ bool updates(const Step& u, int sm) {
  return u.fwd ? sm > u.s : (TR && sm < u.s);
}

// One cluster of C CTAs per chain; warp w of CTA r owns strip r + C w (rows
// and columns 32 s .. 32 s + 31): it alone holds that strip's iterate (a
// register per lane), applies every other strip's solved values to it, and
// solves the strip's diagonal block, forward and backward, in every stage.
// A solved strip is written into every CTA's ysol (distributed shared
// memory) and published by one cluster barrier phase per step; the warp
// that solves the next step's strip applies this step first (look-ahead)
// and arrives after publishing, every other thread arrives at once.
// The traffic sweeps (TR=1) run as the ladder's 36 chains: two CTAs an SM
// keep every cluster resident at once.
template <int C, int TR>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(repro::kStripThreads, TR ? 2 : 1)
chain_kernel_cluster(const float* __restrict__ lu, const float* __restrict__ base,
                     const float* __restrict__ mult, float* __restrict__ x_out, int K, int V,
                     int reverse, int clamp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t chain = blockIdx.x / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = (V + kStrip - 1) / kStrip;
  const int nsteps = 2 * ns * K;
  const int sme = rank + C * warp;              // this warp's strip
  const int r0 = kStrip * sme, nme = sme < ns ? min(kStrip, V - r0) : 0;
  const int j = r0 + lane;                      // this lane's row / column
  const bool live = lane < nme;
  const size_t vv = static_cast<size_t>(V) * V;
  extern __shared__ float sm[];
  float* ysol = sm;                             // (2, V) solved strips, by stage parity
  float* accs = ysol + 2 * V;                   // (32) the row form's backward sums
  float* tbuf = accs + kStrip + warp * kTbufFloats;   // (32, 33) this warp's partials

  auto kof = [&](int st) { return reverse ? K - 1 - st : st; };
  auto fac = [&](int st) { return lu + (chain * K + kof(st)) * vv; };
  auto vec = [&](int st) { return (chain * K + kof(st)) * static_cast<size_t>(V); };

  // the diagonal block: T[c] = m[r0 + c][r0 + lane] (TR=1) or m[r0 + lane][r0 + c]
  float T[kStrip];
  auto load_tile = [&](int st) {
    const float* m = fac(st);
#pragma unroll
    for (int c = 0; c < kStrip; ++c)
      T[c] = (c < nme && live)
                 ? (TR ? __ldg(m + static_cast<size_t>(r0 + c) * V + j)
                       : __ldg(m + static_cast<size_t>(j) * V + r0 + c))
                 : 0.f;
  };
  // the operands of step u's update of this strip: M[q] = m[32 u.s + q][j]
  // (TR=1) or m[r0 + q][32 u.s + lane] (TR=0)
  float M[kStrip];
  auto load_ops = [&](const Step& u) {
    const float* m = fac(u.st);
    const int rs = kStrip * u.s, n = min(kStrip, V - rs);
#pragma unroll
    for (int q = 0; q < kStrip; ++q)
      M[q] = TR ? ((q < n && live) ? __ldg(m + static_cast<size_t>(rs + q) * V + j) : 0.f)
                : (q < nme ? __ldg(m + static_cast<size_t>(r0 + q) * V + rs + lane) : 0.f);
  };

  float v = live ? base[vec(0) + j] + mult[vec(0) + j] * 0.f : 0.f;   // the iterate
  float part[kStrip];                                                 // row form, forward
#pragma unroll
  for (int q = 0; q < kStrip; ++q) part[q] = 0.f;
  if (sme < ns) load_tile(0);

  // step u's update of this strip
  auto apply = [&](const Step& u) {
    const float* ys = ysol + (u.st & 1) * V + kStrip * u.s;
    if (TR) {
      const int n = min(kStrip, V - kStrip * u.s);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kStrip; ++q)
        if (q < n) acc = fmaf(M[q], ys[q], acc);
      if (live) v -= acc;
    } else {
      const float y = ys[lane];
#pragma unroll
      for (int q = 0; q < kStrip; ++q) part[q] = fmaf(M[q], y, part[q]);
    }
  };
  // solve this strip's diagonal block for step u, publish it, and after a
  // backward solve finish the strip's stage
  auto solve = [&](const Step& u) {
    if (!TR && u.fwd) {
      // the forward row sums: lane l's partials to lane q through tbuf
#pragma unroll
      for (int q = 0; q < kStrip; ++q) tbuf[q * (kStrip + 1) + lane] = part[q];
      __syncwarp();
      const float* tb = tbuf + lane * (kStrip + 1);
      float x[kStrip / 2];
#pragma unroll
      for (int l = 0; l < kStrip / 2; ++l) x[l] = tb[l] + tb[l + kStrip / 2];
      __syncwarp();
      v = v - butterfly_sum(x);
    } else if (!TR) {
      v = v - accs[lane];
    }
    // strip_diag_solve's column steps, in its order (T indexed at compile time)
    const bool unit = TR ? !u.fwd : u.fwd;
    if (u.fwd) {
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        if (c >= nme) break;
        if (!unit && lane == c) v = ieee_div(v, T[c]);
        const float yc = __shfl_sync(0xffffffffu, v, c);
        if (lane > c && live) v = fmaf(-T[c], yc, v);
      }
    } else {
#pragma unroll
      for (int c = kStrip - 1; c >= 0; --c) {
        if (c >= nme) continue;
        if (!unit && lane == c) v = ieee_div(v, T[c]);
        const float yc = __shfl_sync(0xffffffffu, v, c);
        if (lane < c && live) v = fmaf(-T[c], yc, v);
      }
    }
    if (live)
      for (int r = 0; r < C; ++r) *cluster.map_shared_rank(ysol + (u.st & 1) * V + j, r) = v;
  };
  auto finish = [&](const Step& u) {
    float x = v;
    if (clamp) x = (x != x) ? x : fmaxf(x, 0.f);
    if (live) x_out[vec(u.st) + j] = x;
    if (u.st + 1 < K) {
      v = live ? base[vec(u.st + 1) + j] + mult[vec(u.st + 1) + j] * x : 0.f;
#pragma unroll
      for (int q = 0; q < kStrip; ++q) part[q] = 0.f;
      load_tile(u.st + 1);
    }
  };

  // every CTA of the cluster runs before any writes into its shared memory;
  // step 0 (strip 0, forward, first stage) needs no update
  cluster.sync();
  if (sme == 0) solve(step_of(0, ns));
  cluster_arrive();
  {
    const Step u0 = step_of(0, ns);
    if (sme < ns && updates<TR>(u0, sme)) load_ops(u0);
  }
  for (int t = 0; t < nsteps; ++t) {
    cluster_wait();
    const Step u = step_of(t, ns);
    bool done = false;
    if (t + 1 < nsteps) {
      const Step u1 = step_of(t + 1, ns);
      if (!TR && !u1.fwd && u1.s % C == rank) {
        // the row form's backward sums of strip u1.s over the strips after
        // it (already solved): every warp of the owning CTA takes 4 rows,
        // lane l the columns 32 (u1.s + 1) + l + 32 k in order
        const float* m = fac(u1.st);
        const float* ys = ysol + (u1.st & 1) * V;
        const int rs = kStrip * u1.s, n1 = min(kStrip, V - rs);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int jj = rs + n1 + lane; jj < V; jj += kStrip) {
          const float y = ys[jj];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int q = 4 * warp + h;
            if (q < n1) acc[h] = fmaf(__ldg(m + static_cast<size_t>(rs + q) * V + jj), y, acc[h]);
          }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], o);
          if (lane == 0) accs[4 * warp + h] = acc[h];
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(repro::kStripThreads) : "memory");
      }
      if (u1.s == sme) {
        if (updates<TR>(u, sme)) apply(u);
        done = true;
        solve(u1);
        cluster_arrive();
        if (!u1.fwd) finish(u1);
      } else {
        cluster_arrive();
      }
    }
    if (sme < ns && !done && updates<TR>(u, sme)) apply(u);
    // the operands of this strip's next update, read ahead
    if (t + 1 < nsteps) {
      const Step u1 = step_of(t + 1, ns);
      if (sme < ns && updates<TR>(u1, sme)) load_ops(u1);
    }
  }
}

template <int NC>
int launch(const float* lu, const float* base, const float* mult, float* x, int B, int K,
           int V, int trans, int reverse, int clamp, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(chain_kernel_pipelined<NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (V % 4 == 0) && (reinterpret_cast<std::uintptr_t>(lu) % 16 == 0);
  chain_kernel_pipelined<NC><<<B, kThreads, smem, stream>>>(lu, base, mult, x, K, V, V | 1,
                                                           trans, reverse, clamp, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int TR>
int launch_cluster(const float* lu, const float* base, const float* mult, float* x, int B, int K,
                   int V, int reverse, int clamp, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * chain_cluster_smem_floats(V);
  auto kernel = chain_kernel_cluster<C, TR>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * C, repro::kStripThreads, smem, stream>>>(lu, base, mult, x, K, V, reverse, clamp);
  return static_cast<int>(cudaGetLastError());
}

template <int TR>
int launch_cluster_c(const float* lu, const float* base, const float* mult, float* x, int B,
                     int K, int V, int reverse, int clamp, cudaStream_t stream) {
  switch (chain_cluster_size(V)) {
    case 2: return launch_cluster<2, TR>(lu, base, mult, x, B, K, V, reverse, clamp, stream);
    case 4: return launch_cluster<4, TR>(lu, base, mult, x, B, K, V, reverse, clamp, stream);
    case 8: return launch_cluster<8, TR>(lu, base, mult, x, B, K, V, reverse, clamp, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at node count V in the given variant
// (0 the factor in shared memory, 1 strips from global memory).
int repro_chain_solve_smem_bytes(int V, int variant) {
  if (variant == 2) return static_cast<int>(sizeof(float)) * chain_cluster_smem_floats(V);
  if (variant == 1)
    return static_cast<int>(sizeof(float)) * (2 * V + repro::kStrip * repro::kStripTileLd);
  const int ld = V | 1;
  return static_cast<int>(sizeof(float)) * (64 + V * ld + 2 * V);
}

// CTAs a cluster of the cluster variant (2) at node count V.
int repro_chain_solve_cluster(int V) { return chain_cluster_size(V); }

// lu: (B, K, V, V), base/mult/x: (B, K, V), float32, contiguous.  variant
// 0 (the factor in shared memory, V <= 239) or 1 (strips), as the
// wrapper's chain_solve_plan picks it.
int repro_chain_solve(const float* lu, const float* base, const float* mult, float* x,
                      int B, int K, int V, int trans, int reverse, int clamp, int variant,
                      cudaStream_t stream) {
  if (B == 0 || K == 0 || V == 0) return 0;
  if (variant == 2) {
    if (chain_cluster_size(V) > kMaxStripCluster) return static_cast<int>(cudaErrorInvalidValue);
    return trans ? launch_cluster_c<1>(lu, base, mult, x, B, K, V, reverse, clamp, stream)
                 : launch_cluster_c<0>(lu, base, mult, x, B, K, V, reverse, clamp, stream);
  }
  if (variant == 1) {
    const int smem = repro_chain_solve_smem_bytes(V, 1);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(chain_kernel_strips,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chain_kernel_strips<<<B, repro::kStripThreads, smem, stream>>>(lu, base, mult, x, K, V,
                                                                   trans, reverse, clamp);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0 || V > 32 * kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = repro_chain_solve_smem_bytes(V, 0);
  switch ((V + 31) / 32) {
    case 1: return launch<1>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 2: return launch<2>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 3: return launch<3>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 4: return launch<4>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 5: return launch<5>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 6: return launch<6>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    case 7: return launch<7>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
    default: return launch<8>(lu, base, mult, x, B, K, V, trans, reverse, clamp, smem, stream);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
