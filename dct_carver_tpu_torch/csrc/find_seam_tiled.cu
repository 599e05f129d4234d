// Find one vertical seam in each of B images whose rows are wider than one
// thread block covers: the masked min-plus DP forward over column tiles in
// K-row blocks, then the argmin of the last row and the backtrack.
//
// Replaces dct_carver_tpu/pallas/dp_kernel.py's streamed route, which takes
// any width: dp_forward (the pl.pallas_call at :124, kernel
// _make_dp_forward_kernel :70) writing the parents and the last DP row to
// HBM row block by row block, the argmin, and dp_backtrack (:184, kernel
// _backtrack_kernel :148), chosen at :596-607.
//
// What bounds it on an H100: latency.  Row r depends on row r-1; one CTA
// of 1024 threads covers at most 32768 columns (dp_rows.cuh), and the
// widest chunks are the slowest.  So the row is cut over CTAs instead, and
// rows stay dependent only within a block of K rows.
//
// Design: the row is cut into tiles of Wt owned columns, and each tile runs
// on its own CTA over an extended row of We = Wt + 2*Hh columns, Hh >= K
// halo columns a side (Hh = K rounded up to 4), with dp_rows<C> (C = 4 at
// the default We = 4096).  One launch runs K rows of every tile of every
// image (B x T CTAs).  Its row 0, the frontier, is the last DP row of the
// launch before, read from a (B, W) buffer (the energy's row 0, through the
// window, for the first), so each CTA starts from exact values on all of
// its extended row; the values it computes from there are exact |dc| rows
// deep at |dc| columns from the extended row's ends (parallel/spatial.py
// :15-19's argument), so on its owned columns for all K rows.  The CTA
// stages its energy rows straight from the (B, H, W) plane (columns outside
// [0, W) are left unset: the window masks them), writes the int8 parents of
// its owned columns only (4-column aligned groups, so no packed word
// straddles two CTAs) into the same (B, H, Wp) scratch as find_seam.cu, and
// writes its owned part of the block's last row to the other of two
// frontier buffers, since its neighbours read their halos from this one.
// A last launch, one CTA an image, takes the tie-most argmin of the last
// frontier and walks the parents up (seam_walk.cuh, shared with
// find_seam.cu).  Launches a seam: ceil((H - 1) / K) + 1.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right).  Cells
// outside [lo_b, lo_b + width_b) are +inf; so are left of column 0 and right
// of column W-1.

#include <algorithm>
#include <climits>

#include "dp_rows.cuh"
#include "seam_walk.cuh"

namespace dct_carver {

constexpr int kFinishThreads = 1024;

// Moves the rows of one tile for dp_rows: row k of the block is plane row
// r0 + k, extended column c is image column col0 + c.  Energy in (16-byte
// copies when VEC; columns outside [0, W) are not read), packed parents
// out for the owned columns [own_lo, own_hi) inside [0, W).
template <bool VEC>
struct TileIo {
  const float* E;
  int8_t* P;
  int W;
  int Wp;
  int r0;
  int col0;
  int own_lo;
  int own_hi;
  __device__ __forceinline__ void load(int k, float* dst, int c) const {
    const int g = col0 + c;
    const float* src = E + static_cast<size_t>(r0 + k) * W + g;
    if (VEC) {
      // g is a multiple of 4 and so is W: the group is inside or outside
      if (g >= 0 && g < W) cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g + i >= 0 && g + i < W) cp_async4(dst + i, src + i);
    }
  }
  __device__ __forceinline__ void store(int k, uint32_t v, int c) const {
    if (c >= own_lo && c < own_hi && col0 + c < W)
      *reinterpret_cast<uint32_t*>(P + static_cast<size_t>(r0 + k) * Wp +
                                   col0 + c) = v;
  }
};

// N DP rows of one tile of one image, from plane row r0 (the frontier F) to
// r0 + N; CTA x = b * tiles + tile.
template <int C, bool VEC, bool RIGHTMOST>
__global__ void __launch_bounds__(kMaxThreads)
tile_rows_kernel(const float* __restrict__ E_all, const float* F,
                 long long f_stride, float* Fn, int8_t* parents_all, int H,
                 int W, int r0, int N, int Wt, int Hh, int tiles,
                 const int* __restrict__ lo_arr,
                 const int* __restrict__ width_arr, int lo0, int width0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles;
  const int col0 = (blockIdx.x - b * tiles) * Wt - Hh;
  const int We = Wt + 2 * Hh;
  const int j0 = threadIdx.x * C;
  const int Wp = parent_pitch(W);
  const int lo = lo_arr ? lo_arr[b] : lo0;
  const int hi = min(lo + (width_arr ? width_arr[b] : width0), W);
  const Window win(lo - col0, min(hi - col0, We), j0, C);
  const float* f = F + b * f_stride + col0 + j0;

  float m[C];
#pragma unroll
  for (int i = 0; i < C; ++i) m[i] = win.has(i) ? f[i] : INFINITY;
  const TileIo<VEC> io{E_all + static_cast<size_t>(b) * H * W,
                       parents_all + static_cast<size_t>(b) * H * Wp,
                       W, Wp, r0, col0, Hh, Hh + Wt};
  dp_rows<C, true, RIGHTMOST>(io, m, N, We, win, smem);

  // the owned part of the block's last row: the next launch's frontier
  float* fn = Fn + static_cast<size_t>(b) * W + col0 + j0;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (j0 + i >= Hh && j0 + i < Hh + Wt && col0 + j0 + i < W) fn[i] = m[i];
}

// The tie-most argmin of each image's last DP row F (through its window)
// and the backtrack over its parents; one CTA an image.
template <bool RIGHTMOST>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ F, long long f_stride,
              const int8_t* __restrict__ parents_all, int* __restrict__ seams,
              int H, int W, const int* __restrict__ lo_arr,
              const int* __restrict__ width_arr, int lo0, int width0) {
  __shared__ __align__(4) int8_t win_s[kSegBytes];
  const int b = blockIdx.x;
  const float* f = F + b * f_stride;
  const int lo = lo_arr ? lo_arr[b] : lo0;
  const int hi = min(lo + (width_arr ? width_arr[b] : width0), W);
  float bv = INFINITY;
  int bj = -1;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const float v = c >= lo && c < hi ? f[c] : INFINITY;
    if (better<RIGHTMOST>(v, c, bv, bj)) {
      bv = v;
      bj = c;
    }
  }
  walk_back(parents_all + static_cast<size_t>(b) * H * parent_pitch(W), H, W,
            block_argmin<RIGHTMOST>(bv, bj),
            seams + static_cast<size_t>(b) * H, win_s);
}

}  // namespace dct_carver

// E: (B, H, W) f32 row-major; parents: (B, H, Wp) int8 scratch, Wp = W
// rounded up to a multiple of 4; seams: (B, H) int32 out; front: (2, B, W)
// f32 scratch.  Image b's DP runs over the column window [lo_b, lo_b +
// width_b), read from lo[b] and width[b] (int32 arrays on the device), or
// lo0 and width0 for every image where the pointer is null.  Wt: owned
// columns a tile (a multiple of 4), K: rows a block; Wt + 2 * (K rounded up
// to 4) <= 32768.  Returns the first cudaError_t of the attribute call or
// of a launch.
extern "C" int dc_find_seams_tiled(const float* E, int8_t* parents,
                                   int* seams, float* front, int B, int H,
                                   int W, const int* lo, const int* width,
                                   int lo0, int width0, int rightmost,
                                   int Wt, int K, void* stream) {
  using namespace dct_carver;
  const int Hh = (K + 3) & ~3;
  if (Wt < 4 || Wt % 4 != 0 || K < 1 || Wt + 2 * Hh > kMaxThreads * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (W + Wt - 1) / Wt;
  if (static_cast<long long>(B) * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte energy copies when every row starts 16-byte aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
  const int We = Wt + 2 * Hh;
  const int err = with_chunk(We, [&](auto c) {
    constexpr int C = decltype(c)::value;
    const int threads = threads_for<C>(We);
    const size_t smem = ring_bytes<C>(threads);
    const auto kernel =
        vec ? (rightmost ? tile_rows_kernel<C, true, true>
                         : tile_rows_kernel<C, true, false>)
            : (rightmost ? tile_rows_kernel<C, false, true>
                         : tile_rows_kernel<C, false, false>);
    if (const int e = allow_smem(kernel, smem)) return e;
    const float* F = E;  // the frontier: row 0 of each plane, then front
    long long f_stride = static_cast<long long>(H) * W;
    for (int r0 = 0, par = 0; r0 < H - 1; r0 += K, par ^= 1) {
      float* Fn = front + static_cast<size_t>(par) * B * W;
      kernel<<<B * tiles, threads, smem, s>>>(
          E, F, f_stride, Fn, parents, H, W, r0, std::min(K, H - 1 - r0), Wt,
          Hh, tiles, lo, width, lo0, width0);
      if (const int e = static_cast<int>(cudaGetLastError())) return e;
      F = Fn;
      f_stride = W;
    }
    const auto finish = rightmost ? finish_kernel<true> : finish_kernel<false>;
    finish<<<B, kFinishThreads, 0, s>>>(F, f_stride, parents, seams, H, W, lo,
                                        width, lo0, width0);
    return static_cast<int>(cudaGetLastError());
  });
  return err;
}
