// The two-sweep substitution on a packed unpivoted LU factor held in shared
// memory, run by one warp; shared by chain_solve.cu and lu_solve.cu.
//
// m is the (V, ld) factor (L strictly below the diagonal with an implicit
// unit diagonal, U on and above it), y the right-hand side, solved in
// place.  trans=0 solves L U x = y: forward over unit-lower L, then
// backward over U with its diagonal.  trans=1 solves (L U)^T x = y:
// forward over U^T (lower, with diagonal), then backward over L^T (unit
// upper), reading the factor's columns by index arithmetic instead of a
// transposed copy; an odd ld keeps those column reads on distinct banks.
//
// Per row: lanes stride the row for a partial dot product, a shuffle tree
// sums it, lane 0 writes the result, and __syncwarp() orders the rows.
// IEEE division, so a zero pivot gives inf/nan exactly as the plain
// PyTorch version does.

#pragma once

namespace repro {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void two_sweep_warp(const float* m, int ld, float* y, int V,
                                               int trans, int lane) {
  // forward sweep: unit-lower L (trans=0) / U^T with its diagonal (trans=1)
  for (int i = 0; i < V; ++i) {
    float acc = 0.f;
    for (int j = lane; j < i; j += 32) acc += (trans ? m[j * ld + i] : m[i * ld + j]) * y[j];
    acc = warp_sum(acc);
    if (lane == 0) y[i] = trans ? (y[i] - acc) / m[i * ld + i] : y[i] - acc;
    __syncwarp();
  }
  // backward sweep: U with its diagonal (trans=0) / unit-upper L^T (trans=1)
  for (int i = V - 1; i >= 0; --i) {
    float acc = 0.f;
    for (int j = i + 1 + lane; j < V; j += 32) acc += (trans ? m[j * ld + i] : m[i * ld + j]) * y[j];
    acc = warp_sum(acc);
    if (lane == 0) y[i] = trans ? y[i] - acc : (y[i] - acc) / m[i * ld + i];
    __syncwarp();
  }
}

}  // namespace repro
