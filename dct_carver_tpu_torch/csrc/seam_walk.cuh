// The end of a seam search, shared by the one-CTA find-seam kernel
// (find_seam.cu) and the finish of the tiled one (find_seam_tiled.cu): the
// tie-most argmin of the last DP row over one block, then the windowed
// backtrack over the int8 parents.
//
// The backtrack walks kSegRows rows at a time: a seam moves at most one
// column a row, so below column j the next kSegRows rows stay inside
// [j - kSegRows, j + kSegRows]; all threads copy that window of parents
// (clamped to [0, W)) into shared memory as aligned 32-bit words, all issued
// before one wait (one round trip), then thread 0 walks it.  Row 0's parents
// are never read.  Parents are -1/0/+1 int8 bytes (the tie-most rule of
// dct_carver_tpu/pallas/dp_kernel.py::_parent_select) in rows of pitch
// parent_pitch(W).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dp_rows.cuh"

namespace dct_carver {

constexpr int kSegRows = 64;  // rows of one backtrack window
// a window of kSegRows rows of 2*kSegRows + 1 columns, each row widened to
// whole aligned words
constexpr size_t kSegBytes = kSegRows * (2 * kSegRows + 8);

// The row pitch of the parents scratch; kernels/dp_kernel.py allocates it.
__host__ __device__ inline int parent_pitch(int W) { return (W + 3) & ~3; }

// True when (v, j) beats (bv, bj): a smaller value, or an equal value
// further towards the tie side.  bj < 0 marks "nothing yet".
template <bool RIGHTMOST>
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  if (bj < 0) return true;
  if (v < bv) return true;
  if (v == bv) return RIGHTMOST ? j > bj : j < bj;
  return false;
}

// The tie-most argmin of the threads' candidates (bv, bj), bj < 0 for none,
// returned to every thread.  `better` is a total order, so the candidates
// may come in any order.  All threads of the block call it; blockDim.x is
// a multiple of 32.
template <bool RIGHTMOST>
__device__ int block_argmin(float bv, int bj) {
  __shared__ float red_v[32];
  __shared__ int red_j[32];
  __shared__ int s_j;
  const int t = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    if (oj >= 0 && better<RIGHTMOST>(ov, oj, bv, bj)) {
      bv = ov;
      bj = oj;
    }
  }
  if (t % 32 == 0) {
    red_v[t / 32] = bv;
    red_j[t / 32] = bj;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w)
      if (red_j[w] >= 0 && better<RIGHTMOST>(red_v[w], red_j[w], bv, bj)) {
        bv = red_v[w];
        bj = red_j[w];
      }
    s_j = bj;
  }
  __syncthreads();
  return s_j;
}

// The seam of one image from column j of its last row: seam[H-1] = j, then
// the windowed backtrack over its parents P (H rows of pitch
// parent_pitch(W)).  win_s: kSegBytes of 4-byte aligned shared memory.  All
// threads of the block call it.
__device__ inline void walk_back(const int8_t* __restrict__ P, int H, int W,
                                 int j, int* __restrict__ seam,
                                 int8_t* win_s) {
  __shared__ int s_j;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int Wp = parent_pitch(W);
  const int ww = min(2 * kSegRows + 1, W);
  if (t == 0) seam[H - 1] = j;
  for (int top = H - 1; top > 0; top -= kSegRows) {
    const int rows = min(kSegRows, top);  // parent rows top .. top-rows+1
    const int ws = min(max(j - kSegRows, 0), W - ww);
    const int ws4 = ws & ~3;
    const int words = (ws + ww - ws4 + 3) / 4;  // a window row, in words
    for (int e = t; e < rows * words; e += T) {
      const int r = e / words;
      const int w = e - r * words;
      cp_async4(reinterpret_cast<float*>(win_s) + e,
                reinterpret_cast<const float*>(
                    P + static_cast<size_t>(top - r) * Wp + ws4) + w);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (t == 0) {
      const int pitch = 4 * words;
      const int first = ws - ws4;  // the window's columns in its rows
      int jl = j - ws4;
      for (int r = 0; r < rows; ++r) {
        jl = min(max(jl + win_s[r * pitch + jl], first), first + ww - 1);
        seam[top - r - 1] = jl + ws4;
      }
      s_j = jl + ws4;
    }
    __syncthreads();
    j = s_j;
  }
}

}  // namespace dct_carver
