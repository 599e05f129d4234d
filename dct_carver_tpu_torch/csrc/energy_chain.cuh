// The DCT energy of one pixel, shared by the full-map kernel (energy.cu), the
// strip kernel (strip.cu) and the band kernel (strip_bands.cu).  All call
// the same device function, so a strip update, a full recompute and the
// energy of gathered bands run the identical op sequence and agree bit for
// bit.
//
// Contract: dct_carver_tpu_torch/ops/dct.py::energy_from_bands (and the JAX
// package's ops/dct.py:84-116).  For each ky, the n values V[ky][col+dx] are
// n-term dy chains over edge-clamped rows; for each kx, the coefficient is
// the n-term dx chain over V.  The DC atom is excluded; the largest |coeff|
// wins, and among equal values the largest rank kx*n+ky.  The result is
// multiplied by `edges` when the winner is atom (0,1) or (1,0) (rank 1 or
// n), else by `textures`.  Every multiply and add is rounded on its own
// (__fmul_rn/__fadd_rn, and the library is built with -fmad=false): a fused
// multiply-add would change the low bits and break bitwise parity with the
// plain PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dct_carver {

// Copy the n*n f32 taps (row k = frequency, column j = sample) into shared
// memory.  Every thread of the block must call it (it synchronises).
__device__ __forceinline__ void load_taps(const float* __restrict__ taps,
                                          float* s_taps, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n * n; i += blockDim.x * blockDim.y) s_taps[i] = taps[i];
  __syncthreads();
}

// The chain of one pixel over a window whose row d starts at src + roff[d]
// and whose column dx is at index cidx[dx] of each row.  The caller picks
// the addressing: clamped rows and columns of a luma plane (energy_at, for
// energy.cu and strip.cu) or the rows of a gathered band (strip_bands.cu),
// so every kernel runs this one op sequence.  D is the n*n tap matrix in
// shared memory.
template <int N>
__device__ __forceinline__ float energy_chain(const float* __restrict__ src,
                                              const int (&roff)[N],
                                              const int (&cidx)[N],
                                              const float* D, float edges,
                                              float textures) {
  float maxval = -INFINITY;
  int winner = -1;
#pragma unroll 1
  for (int ky = 0; ky < N; ++ky) {
    const float* Dy = D + ky * N;
    float V[N];
#pragma unroll
    for (int dx = 0; dx < N; ++dx) {
      float v = __fmul_rn(Dy[0], __ldg(src + roff[0] + cidx[dx]));
#pragma unroll
      for (int dy = 1; dy < N; ++dy)
        v = __fadd_rn(v, __fmul_rn(Dy[dy], __ldg(src + roff[dy] + cidx[dx])));
      V[dx] = v;
    }
#pragma unroll
    for (int kx = 0; kx < N; ++kx) {
      if (ky == 0 && kx == 0) continue;  // DC atom (src/dct.c:103)
      const float* Dx = D + kx * N;
      float t = __fmul_rn(Dx[0], V[0]);
#pragma unroll
      for (int dx = 1; dx < N; ++dx) t = __fadd_rn(t, __fmul_rn(Dx[dx], V[dx]));
      const float a = fabsf(t);
      const int rank = kx * N + ky;
      if (a > maxval) {
        maxval = a;
        winner = rank;
      } else if (a == maxval) {
        winner = max(winner, rank);
      }
    }
  }
  const bool is_edge = winner == 1 || winner == N;
  return __fmul_rn(maxval, is_edge ? edges : textures);
}

// Energy of pixel (row, col) of the (H, W) row-major luma plane.  The window
// starts `co` rows/columns before the pixel (ops/dct.py::window_offset) and
// is clamped to the plane.
template <int N>
__device__ __forceinline__ float energy_at(const float* __restrict__ luma,
                                           int H, int W, int row, int col,
                                           int co, const float* D,
                                           float edges, float textures) {
  int roff[N];
  int cidx[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    roff[d] = min(max(row + co + d, 0), H - 1) * W;
    cidx[d] = min(max(col + co + d, 0), W - 1);
  }
  return energy_chain<N>(luma, roff, cidx, D, edges, textures);
}

}  // namespace dct_carver
