// The two-sweep substitution on a packed unpivoted LU factor that stays in
// global memory, run by a whole thread block; shared by chain_solve.cu and
// lu_solve.cu for node counts whose factor does not fit one block's shared
// memory (lu_solve above V = 240; chain_solve above V = 2048, its cluster
// variant below that takes these operations in this order too).
//
// m is the (V, V) row-major factor (L strictly below the diagonal with an
// implicit unit diagonal, U on and above it), y the right-hand side in
// shared memory, solved in place.  trans=0 solves L U x = y, trans=1
// (L U)^T x = y, as two_sweep.cuh does.
//
// The rows are cut into strips of 32 (the last may be shorter).  Each
// sweep walks the strips in its order, and every read of the factor is a
// row read (neighbouring threads on neighbouring addresses):
//   * trans=0 (forward over L, backward over U): the row form.  A strip's
//     rows first take the dot product of their entries left (forward) or
//     right (backward) of the strip with the y already solved: warp w takes
//     rows w, w+8, w+16, w+24 of the strip, its lanes stride the row, and a
//     shuffle tree sums them; then warp 0 solves the strip's 32 x 32
//     diagonal block (staged in shared memory), lane q holding y of row q,
//     one column at a time (broadcast by shuffle, then each lower (upper)
//     lane's fused multiply-subtract, the division by U's pivot for the
//     backward sweep);
//   * trans=1 (forward over U^T, backward over L^T): the column form.  Warp
//     0 solves the strip's diagonal block first, then every thread takes
//     columns j right (forward) or left (backward) of the strip and
//     subtracts the sum over the strip's 32 rows of m[row][j] * y[row].
// Shared memory besides y: the diagonal block, 32 x 33 floats.  So V is
// bounded by the 2 V floats of y and the iterate alone.
//
// The sums run in another order than the plain version's (per row, the
// strips' partial sums), so the results agree within float32 rounding, not
// bit for bit.  IEEE division, so a zero pivot gives inf/nan in the member
// as the plain version does.

#pragma once

namespace repro {

constexpr int kStrip = 32;
constexpr int kStripThreads = 256;
constexpr int kStripWarps = kStripThreads / 32;
constexpr int kStripTileLd = kStrip + 1;

__device__ __forceinline__ float strip_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage the strip's diagonal block m[r0 + q][r0 + c] as tile[q][c].
__device__ __forceinline__ void strip_load_tile(const float* m, int V, int r0, int n,
                                                float* tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < n; q += kStripWarps)
    if (lane < n) tile[q * kStripTileLd + lane] = m[static_cast<size_t>(r0 + q) * V + r0 + lane];
}

// Row form: y[r0 + q] -= sum over j in [j0, j1) of m[r0 + q][j] y[j].
__device__ __forceinline__ void strip_rows_dot(const float* m, int V, int r0, int n, int j0,
                                               int j1, float* y) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < n; q += kStripWarps) {
    const float* row = m + static_cast<size_t>(r0 + q) * V;
    float acc = 0.f;
    for (int j = j0 + lane; j < j1; j += 32) acc = fmaf(row[j], y[j], acc);
    acc = strip_warp_sum(acc);
    if (lane == 0) y[r0 + q] -= acc;
  }
}

// Column form: y[j] -= sum over q of m[r0 + q][j] y[r0 + q], j in [j0, j1).
__device__ __forceinline__ void strip_cols_axpy(const float* m, int V, int r0, int n, int j0,
                                                int j1, float* y) {
  for (int j = j0 + threadIdx.x; j < j1; j += kStripThreads) {
    const float* col = m + static_cast<size_t>(r0) * V + j;
    float acc = 0.f;
    for (int q = 0; q < n; ++q) acc = fmaf(col[static_cast<size_t>(q) * V], y[r0 + q], acc);
    y[j] -= acc;
  }
}

// Warp 0's solve of the strip's diagonal block (see above).  lower: the
// block is lower triangular in the solve's row order (a forward sweep);
// tr: the block is read transposed (trans=1); unit: no division.
__device__ __forceinline__ void strip_diag_solve(const float* tile, int r0, int n, float* y,
                                                 bool lower, bool tr, bool unit) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float v = lane < n ? y[r0 + lane] : 0.f;
  for (int s = 0; s < n; ++s) {
    const int c = lower ? s : n - 1 - s;
    if (!unit && lane == c) v = v / tile[c * kStripTileLd + c];
    const float yc = __shfl_sync(0xffffffffu, v, c);
    const bool below = lower ? lane > c : lane < c;
    if (below && lane < n)
      v = fmaf(-(tr ? tile[c * kStripTileLd + lane] : tile[lane * kStripTileLd + c]), yc, v);
  }
  if (lane < n) y[r0 + lane] = v;
}

// Both sweeps on y (shared memory) from the factor m (global memory); the
// whole block calls it, and y holds the solution on return.
__device__ __forceinline__ void strip_two_sweep(const float* m, int V, float* y, int trans,
                                                float* tile) {
  const int ns = (V + kStrip - 1) / kStrip;
  // forward: unit-lower L (trans=0) / U^T with its diagonal (trans=1)
  for (int s = 0; s < ns; ++s) {
    const int r0 = s * kStrip, n = min(kStrip, V - r0);
    if (trans) {
      strip_load_tile(m, V, r0, n, tile);
      __syncthreads();
      strip_diag_solve(tile, r0, n, y, true, true, false);
      __syncthreads();
      strip_cols_axpy(m, V, r0, n, r0 + n, V, y);
    } else {
      strip_rows_dot(m, V, r0, n, 0, r0, y);
      strip_load_tile(m, V, r0, n, tile);
      __syncthreads();
      strip_diag_solve(tile, r0, n, y, true, false, true);
    }
    __syncthreads();
  }
  // backward: U with its diagonal (trans=0) / unit-upper L^T (trans=1)
  for (int s = ns - 1; s >= 0; --s) {
    const int r0 = s * kStrip, n = min(kStrip, V - r0);
    if (trans) {
      strip_load_tile(m, V, r0, n, tile);
      __syncthreads();
      strip_diag_solve(tile, r0, n, y, false, true, true);
      __syncthreads();
      strip_cols_axpy(m, V, r0, n, 0, r0, y);
    } else {
      strip_rows_dot(m, V, r0, n, r0 + n, V, y);
      strip_load_tile(m, V, r0, n, tile);
      __syncthreads();
      strip_diag_solve(tile, r0, n, y, false, false, false);
    }
    __syncthreads();
  }
}

}  // namespace repro
