// The parts the two blocked-set kernels share (tagged.cu, the dense route;
// tagged_nbr.cu, the neighbor-list route): a thread-block cluster a member
// (one CTA at small V), the tagged-node fixed point with the bitset in every
// CTA's shared memory, and the write of the member's (V, V) blocked mask.
//
// Rows.  The member's V rows go to the cluster's C CTAs by whole 32-bit
// words of the bitset: CTA r owns words [r * WR, (r + 1) * WR), rows
// 32 r WR up to 32 (r + 1) WR (fewer in the last CTA, none in a CTA past V).
// A warp computes 32 rows, so __ballot_sync gives it a word of the bitset
// whole.
//
// Rounds.  T_0 = 0 and T_j[p] = hit(p, T_{j-1}), the caller's row map, until
// a round changes nothing: the least fixed point, since the map is monotone.
// The bitset is double-buffered, T_j in buffer j & 1 of every CTA: the warp
// that computes a word stores it into every CTA's buffer (distributed shared
// memory, one lane a CTA), and one cluster barrier (release / acquire) ends
// the round.  A round's readers of buffer (j - 2) & 1 are all behind the
// barrier that ended round j - 1, so round j may overwrite it.  A warp whose
// word changed stamps j into flags[j & 1] of every CTA; after the barrier
// every CTA reads the same stamp, so all leave the loop at the same round
// with no second barrier.  (A stamp and not a 0/1 flag: the slot is never
// cleared, and a stamp from round j - 2 cannot be taken for round j's.)
// Within V + 1 rounds the bitset settles (at most V rounds add a bit), which
// is also the loop's cap.
//
// The mask.  out[p, q] = !adj[p, q] | worse[p, q] | tagged[q]: the worse
// bits (words formed before, or compared on the fly from pdt) OR the final
// bitset's, spread to bytes four at a time ((nibble * 0x00204081) &
// 0x01010101) and written 16 (write_mask, V >= 16) or 4 (write_mask_pdt)
// bytes a thread where V % 4 == 0 (then every row slice of 32 rows starts
// on a 16-byte boundary), the adj reads of four chunks issued together; one
// byte a thread otherwise.  The dense kernel keeps its worse words for
// write_mask: comparing pdt on the fly in its place was slower there.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blocked {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Per-CTA phase stamps for scripts/blocked_set_phases.py, compiled in only
// with -DREPRO_BLOCKED_STAMPS (no code otherwise): BLOCKED_STAMP(i) has
// thread 0 record the card's %globaltimer (ns) in slot i of its CTA's row,
// BLOCKED_STAMP_VALUE(i, v) records v, BLOCKED_STAMP_SYNC() is a CTA
// barrier that lets the stamp after it close a phase of every thread.
#ifdef REPRO_BLOCKED_STAMPS
__device__ unsigned long long g_stamps[1 << 15][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BLOCKED_STAMP_VALUE(i, v) \
  do { if (threadIdx.x == 0) blocked::g_stamps[blockIdx.x][i] = (v); } while (0)
#define BLOCKED_STAMP_SYNC() __syncthreads()
#else
#define BLOCKED_STAMP_VALUE(i, v) ((void)0)
#define BLOCKED_STAMP_SYNC() ((void)0)
#endif
#define BLOCKED_STAMP(i) BLOCKED_STAMP_VALUE(i, blocked::gtime())

template <int C>
__device__ __forceinline__ int cta_rank() {
  if constexpr (C == 1) return 0;
  else return static_cast<int>(cg::this_cluster().block_rank());
}

template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C == 1) __syncthreads();
  else cg::this_cluster().sync();
}

// Lane c (< C) stores v at p in the shared memory of the cluster's CTA c.
template <int C>
__device__ __forceinline__ void store_all(uint32_t* p, uint32_t v, int lane) {
  if constexpr (C == 1) {
    if (lane == 0) *p = v;
  } else {
    if (lane < C) *cg::this_cluster().map_shared_rank(p, lane) = v;
  }
}

// This CTA's share of the member's rows: words [word0, word0 + nwords),
// rows [row0, row0 + nrows).
struct Rows {
  int word0, nwords, row0, nrows;
};

__device__ __forceinline__ Rows rows_of(int rank, int WR, int V) {
  const int W = (V + 31) >> 5;
  Rows r;
  r.word0 = rank * WR;
  r.nwords = max(0, min(W, r.word0 + WR) - r.word0);
  r.row0 = 32 * r.word0;
  r.nrows = max(0, min(V, r.row0 + 32 * r.nwords) - r.row0);
  return r;
}

// The fixed point.  On entry T[0, W) is zero and flags[0, 2) zero in every
// CTA of the cluster, and the cluster has synchronised since.  hit(pl, cur)
// is local row pl's flag in the round that reads bitset cur (false for
// pl >= nrows).  Returns the rounds run (the first one forms the seed); the
// fixed point is T + (rounds & 1) * W.
template <int C, class Hit>
__device__ int fixed_point(uint32_t* T, uint32_t* flags, int W, const Rows& r, int cap,
                           Hit hit) {
  const int lane = threadIdx.x & 31;
  for (int j = 1;; ++j) {
    const uint32_t* cur = T + ((j - 1) & 1) * W;
    uint32_t* nxt = T + (j & 1) * W;
    // whole warps: 32 * nwords and kThreads are multiples of 32
    for (int pl = threadIdx.x; pl < 32 * r.nwords; pl += kThreads) {
      const uint32_t bits = __ballot_sync(0xffffffffu, hit(pl, cur));
      const int word = r.word0 + (pl >> 5);
      store_all<C>(nxt + word, bits, lane);
      if (bits != cur[word]) store_all<C>(flags + (j & 1), static_cast<uint32_t>(j), lane);
    }
    cluster_sync<C>();
    if (flags[j & 1] != static_cast<uint32_t>(j) || j >= cap) return j;
  }
}

// Bit i of the nibble: x[i] > t (false for NaN on either side).
__device__ __forceinline__ uint32_t nibble_gt(float4 a, float t) {
  return static_cast<uint32_t>(a.x > t) | (static_cast<uint32_t>(a.y > t) << 1)
         | (static_cast<uint32_t>(a.z > t) << 2) | (static_cast<uint32_t>(a.w > t) << 3);
}

// A 128-column segment of a row read 16 bytes a lane (lane l: columns
// 4l .. 4l + 3, a nibble), as four 32-bit words: the nibbles of the 8 lanes
// 8g .. 8g + 7 ORed into word g (butterfly shuffles within the group), which
// every lane of the group gets.
__device__ __forceinline__ uint32_t group_word(uint32_t nib, int lane) {
  uint32_t x = nib << (4 * (lane & 7));
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  x |= __shfl_xor_sync(0xffffffffu, x, 2);
  x |= __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Bits q .. q + 15 of a bitset (bit i: column q + i).
__device__ __forceinline__ uint32_t bits16(const uint32_t* x, int W, int q) {
  const int w0 = q >> 5;
  return __funnelshift_r(x[w0], w0 + 1 < W ? x[w0 + 1] : 0u, q & 31);
}

// Four bits to four 0/1 bytes, bit i to byte i.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return ((nib & 0xfu) * 0x00204081u) & 0x01010101u;
}

// out[p, q] = !adj[p, q] | bit q of (WW row p | T) for rows [row0, row0 +
// nrows) of one member: out and adj point at the member's (V, V) bytes, WW
// holds the CTA's rows' worse words (W words a row, row by row), T is the
// final bitset.  vec: V % 4 == 0 and both pointers 16-byte aligned; the
// 16-byte chunks are taken only where V >= 16, so that a chunk covers at
// most the tail of one row and the head of the next.
__device__ void write_mask(uint8_t* __restrict__ out, const uint8_t* __restrict__ adj,
                           const uint32_t* WW, const uint32_t* T, int V, const Rows& r,
                           int vec) {
  const int W = (V + 31) >> 5;
  const int beg = r.row0 * V;       // a member's V^2 bytes fit an int
  const int end = beg + r.nrows * V;
  if (vec && V >= 16) {
    // kAhead chunks a thread at a time, their adj loads issued together
    constexpr int kAhead = 4;
    for (int f0 = beg + 16 * static_cast<int>(threadIdx.x); f0 < end;
         f0 += kAhead * 16 * kThreads) {
      uint4 a[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int f = f0 + u * 16 * kThreads;
        if (f < end) a[u] = __ldg(reinterpret_cast<const uint4*>(adj + f));
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int f = f0 + u * 16 * kThreads;
        if (f >= end) break;
        const int p = f / V;
        const int q = f - p * V;
        const uint32_t* x = WW + (p - r.row0) * W;
        // a chunk that runs into the next row takes that row's first bits
        // above its own (neither holds a bit past column V - 1)
        uint32_t bits = bits16(x, W, q) | bits16(T, W, q);
        if (q + 16 > V) bits |= (bits16(x + W, W, 0) | bits16(T, W, 0)) << (V - q);
        uint4 v;
        v.x = spread4(bits) | (a[u].x ^ 0x01010101u);
        v.y = spread4(bits >> 4) | (a[u].y ^ 0x01010101u);
        v.z = spread4(bits >> 8) | (a[u].z ^ 0x01010101u);
        v.w = spread4(bits >> 12) | (a[u].w ^ 0x01010101u);
        *reinterpret_cast<uint4*>(out + f) = v;
      }
    }
  } else {
    for (int f = beg + static_cast<int>(threadIdx.x); f < end; f += kThreads) {
      const int p = f / V;
      const int q = f - p * V;
      const uint32_t* x = WW + (p - r.row0) * W;
      const uint32_t bit = ((x[q >> 5] | T[q >> 5]) >> (q & 31)) & 1u;
      out[f] = static_cast<uint8_t>(bit | (__ldg(adj + f) ^ 1u));
    }
  }
}

// The same mask with the worse bits compared on the fly from pdt in shared
// memory (ps, 16-byte aligned): vec (V % 4 == 0, out and adj 16-byte
// aligned) 4 bytes a thread, a warp on 128 consecutive bytes, so a lane's
// 16 bytes of pdt follow its neighbour's (no bank conflict) and no word
// runs into the next row; one byte a thread otherwise.
__device__ void write_mask_pdt(uint8_t* __restrict__ out, const uint8_t* __restrict__ adj,
                               const float* ps, float eps, const uint32_t* T, int V,
                               const Rows& r, int vec) {
  const int beg = r.row0 * V;
  const int end = beg + r.nrows * V;
  if (vec) {
    constexpr int kAhead = 4;
    constexpr int kStep = 4 * kThreads;          // bytes a pass of the CTA covers
    // a thread's row and column, stepped along by a pass's dp rows and dq
    // columns without a division
    int p = r.row0 + (4 * static_cast<int>(threadIdx.x)) / V;
    int q = 4 * static_cast<int>(threadIdx.x) - (p - r.row0) * V;
    const int dp = kStep / V;
    const int dq = kStep - dp * V;
    for (int f0 = beg + 4 * static_cast<int>(threadIdx.x); f0 < end; f0 += kAhead * kStep) {
      uint32_t a[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int f = f0 + u * kStep;
        if (f < end) a[u] = __ldg(reinterpret_cast<const uint32_t*>(adj + f));
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int f = f0 + u * kStep;
        if (f >= end) break;
        const float thr = __fadd_rn(ps[p], eps);
        const uint32_t nib = nibble_gt(*reinterpret_cast<const float4*>(ps + q), thr)
                             | (T[q >> 5] >> (q & 31));
        *reinterpret_cast<uint32_t*>(out + f) = spread4(nib) | (a[u] ^ 0x01010101u);
        q += dq;
        p += dp;
        if (q >= V) q -= V, ++p;
      }
    }
  } else {
    for (int f = beg + static_cast<int>(threadIdx.x); f < end; f += kThreads) {
      const int p = f / V;
      const int q = f - p * V;
      const uint32_t bit = static_cast<uint32_t>(ps[q] > __fadd_rn(ps[p], eps))
                           | ((T[q >> 5] >> (q & 31)) & 1u);
      out[f] = static_cast<uint8_t>(bit | (__ldg(adj + f) ^ 1u));
    }
  }
}

// The CTA's rows of the final bitset as 0/1 bytes (out: the member's V).
__device__ __forceinline__ void write_tagged(uint8_t* __restrict__ out, const uint32_t* T,
                                             const Rows& r) {
  for (int pl = threadIdx.x; pl < r.nrows; pl += kThreads) {
    const int p = r.row0 + pl;
    out[p] = static_cast<uint8_t>((T[p >> 5] >> (p & 31)) & 1u);
  }
}

}  // namespace blocked

#ifdef REPRO_BLOCKED_STAMPS
// The stamps of the first n CTAs, 8 a CTA, into host memory.
extern "C" int repro_blocked_stamps(unsigned long long* host, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, blocked::g_stamps, sizeof(unsigned long long) * 8 * n));
}
#endif
