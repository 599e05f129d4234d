// The parts of the DCT energy, shared by the full-map kernel (energy.cu), the
// strip kernel (strip.cu) and the band kernel (strip_bands.cu).  All build
// each coefficient from the same chains in the same op order, so a strip
// update, a full recompute and the energy of gathered bands agree bit for
// bit, however each kernel spreads the chains over its threads.
//
// Contract: dct_carver_tpu_torch/ops/dct.py::energy_from_bands (and the JAX
// package's ops/dct.py:84-116).  For each ky, the n values V[ky][col+dx] are
// n-term dy chains over edge-clamped rows (the vertical chain); for each kx,
// the coefficient is the n-term dx chain over V (the atom chain).  The DC
// atom is excluded; the largest |coeff| wins, and among equal values the
// largest rank kx*n+ky (the pick).  The result is multiplied by `edges` when
// the winner is atom (0,1) or (1,0) (rank 1 or n), else by `textures`.
// Every multiply and add is rounded on its own (__fmul_rn/__fadd_rn, and the
// library is built with -fmad=false): a fused multiply-add would change the
// low bits and break bitwise parity with the plain PyTorch version.
//
// The pick is the largest (|coeff|, rank) pair in lexicographic order, so it
// does not depend on the order in which atoms are seen: atoms may be spread
// over threads and their picks combined in any order (Pick::add).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dct_carver {

// The n*n f32 taps (row k = frequency, column j = sample) by value: as a
// kernel parameter they sit in constant memory, and a multiply whose tap
// index is known at compile time takes the tap as an operand, with no load
// and no register.
template <int N>
struct Taps {
  float d[N * N];
  __device__ __forceinline__ float operator()(int k, int j) const {
    return d[k * N + j];
  }
};

// One chain: sum_j D(k, j) * x(j), j = 0 .. N-1 in order, each op rounded.
// The vertical chain is chain(D, ky, band column), the atom chain
// chain(D, kx, V row).
template <int N, class D, class X>
__device__ __forceinline__ float chain(const D& taps, int k, X x) {
  float v = __fmul_rn(taps(k, 0), x(0));
#pragma unroll
  for (int j = 1; j < N; ++j) v = __fadd_rn(v, __fmul_rn(taps(k, j), x(j)));
  return v;
}

// A running pick: the largest |coeff| and, among equals, the largest rank.
// It starts at (-inf, -1); a NaN never enters, as in the sequential loop.
struct Pick {
  float v = -INFINITY;
  int rank = -1;
  // Take (a, r) when a is larger, or equal with a larger rank.  Also the
  // combine of two picks: add(other.v, other.rank).
  __device__ __forceinline__ void add(float a, int r) {
    if (a > v || (a == v && r > rank)) {
      v = a;
      rank = r;
    }
  }
  template <int N>
  __device__ __forceinline__ float energy(float edges, float textures) const {
    const bool is_edge = rank == 1 || rank == N;
    return __fmul_rn(v, is_edge ? edges : textures);
  }
};

// The pick of one ky row of atoms: x(kx) gives the coefficient of atom
// (kx, ky).  Ranks grow with kx within a ky, so a later equal value wins
// (>=); the row's pick then joins `p` by the full rule.
template <int N, class X>
__device__ __forceinline__ void pick_row(Pick& p, int ky, X coeff) {
  float m = -INFINITY;
  int best = -1;
#pragma unroll
  for (int kx = 0; kx < N; ++kx) {
    if (kx == 0 && ky == 0) continue;  // DC atom (src/dct.c:103)
    const float a = fabsf(coeff(kx));
    if (a >= m) {
      m = a;
      best = kx;
    }
  }
  if (best >= 0) p.add(m, best * N + ky);
}

}  // namespace dct_carver
