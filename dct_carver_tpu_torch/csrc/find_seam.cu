// Find one vertical seam in each of B images: the masked min-plus DP
// forward, the argmin of the last row, and the backtrack, in one kernel with
// one thread block per image.
//
// Replaces dct_carver_tpu/pallas/dp_kernel.py::_fused_find_seam_batched
// (the pl.pallas_call at :348, body _make_fused_seam_kernel :212 /
// _fused_seam_body :249), reached through find_seam_pallas :572, and
// dct_carver_tpu/pallas/batch_dp_kernel.py::find_seams_vec (the forward at
// :139, _make_vec_dp_kernel :48, and the backtrack at :171,
// _make_vec_bt_kernel :93), which the batch route reaches through the
// custom_vmap rule of dp_kernel.py::_find_seam_cv.  The same kernel covers
// the TPU's folded single-image route (the pair at :523/:553), which exists
// only because of the TPU's VMEM size and lane layout.  Rows wider than one
// CTA covers (32768 columns) take find_seam_tiled.cu, the counterpart of
// the streamed route (dp_forward :124, dp_backtrack :184).
//
// What bounds it on an H100: latency, not bytes (E read once, int8 parents
// written once: 5 * B * H * W).  Row r depends on row r-1, so each image's
// H rows run one after the other, each a block-wide barrier plus the row's
// column work; the B images are independent CTAs.  A row must not also wait
// for a load: a dependent read of the energy from L2 or HBM after each
// barrier costs more than the rest of the row.
//
// Design (dp_rows.cuh): each thread owns C contiguous columns, its part of
// the frontier in registers, and exchanges only its edge cells through
// shared memory, one barrier a row.  The CTA is ceil(W / C) threads, C the
// narrowest chunk (4, 8, 16 or 32 columns) that keeps it within 1024
// threads: 4 columns, so up to 1024 threads, for W up to 4096; at the batch
// route's W = 1024 the CTA is 256 threads and several images share an SM.
// Energy rows are staged kStages - 1 rows ahead with coalesced cp.async
// copies (16 bytes when rows are 16-byte aligned, else 4) into a ring in
// shared memory, and the column window [lo_b, lo_b + width_b) is applied
// when a value is used.  Parents (-1/0/+1, the tie-most rule of
// dp_kernel.py::_parent_select) are packed four to a word and stored,
// coalesced, to an int8 (B, H, Wp) scratch, Wp = W rounded up to 4.  A
// block reduction finds the tie-most argmin of the last row, and the
// windowed backtrack (seam_walk.cuh) walks the parents up.  The TPU's
// sublane packing of the batch and its one-hot backtrack exist for the
// VPU's layout and are not copied.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right).  Cells
// outside [lo_b, lo_b + width_b) are +inf; so are left of column 0 and right
// of column W-1.

#include <algorithm>

#include "dp_rows.cuh"
#include "seam_walk.cuh"

namespace dct_carver {

// Moves the rows of one image for dp_rows: energy rows in (16-byte copies
// when VEC), packed parents out.
template <bool VEC>
struct SeamIo {
  const float* E;
  int8_t* P;
  int W;
  int Wp;
  __device__ __forceinline__ void load(int k, float* dst, int c) const {
    const float* src = E + static_cast<size_t>(k) * W + c;
    if (VEC) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < W) cp_async4(dst + i, src + i);
    }
  }
  __device__ __forceinline__ void store(int k, uint32_t v, int c) const {
    *reinterpret_cast<uint32_t*>(P + static_cast<size_t>(k) * Wp + c) = v;
  }
};

template <int C, bool VEC, bool RIGHTMOST>
__global__ void __launch_bounds__(kMaxThreads)
find_seam_kernel(const float* __restrict__ E_all, int8_t* parents_all,
                 int* __restrict__ seams, int H, int W,
                 const int* __restrict__ lo_arr,
                 const int* __restrict__ width_arr, int lo0, int width0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float inf = INFINITY;
  const int j0 = threadIdx.x * C;
  const size_t b = blockIdx.x;
  const float* E = E_all + b * H * W;
  const int Wp = parent_pitch(W);
  int8_t* P = parents_all + b * H * Wp;
  const int lo = lo_arr ? lo_arr[b] : lo0;
  const int hi = min(lo + (width_arr ? width_arr[b] : width0), W);
  const Window win(lo, hi, j0, C);

  float m[C];
#pragma unroll
  for (int i = 0; i < C; ++i) m[i] = win.has(i) ? E[j0 + i] : inf;
  dp_rows<C, true, RIGHTMOST>(SeamIo<VEC>{E, P, W, Wp}, m, H - 1, W, win,
                              smem);

  // tie-most argmin of the last row (cells outside the window hold +inf)
  float bv = inf;
  int bj = -1;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (j0 + i < W && better<RIGHTMOST>(m[i], j0 + i, bv, bj)) {
      bv = m[i];
      bj = j0 + i;
    }
  // the backtrack's window aliases the ring, which is done with
  walk_back(P, H, W, block_argmin<RIGHTMOST>(bv, bj), seams + b * H,
            reinterpret_cast<int8_t*>(smem));
}

}  // namespace dct_carver

// E: (B, H, W) f32 row-major; parents: (B, H, Wp) int8 scratch, Wp = W
// rounded up to a multiple of 4; seams: (B, H) int32 out.  Image b's DP runs
// over the column window [lo_b, lo_b + width_b), read from lo[b] and
// width[b] (int32 arrays on the device), or lo0 and width0 for every image
// where the pointer is null.  W <= 32768 (wider rows: dc_find_seams_tiled).
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int dc_find_seams(const float* E, int8_t* parents, int* seams,
                             int B, int H, int W, const int* lo,
                             const int* width, int lo0, int width0,
                             int rightmost, void* stream) {
  using namespace dct_carver;
  // 16-byte energy copies when every row starts 16-byte aligned
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
  return with_chunk(W, [&](auto c) {
    constexpr int C = decltype(c)::value;
    const int threads = threads_for<C>(W);
    const size_t smem = std::max(ring_bytes<C>(threads), kSegBytes);
    const auto kernel =
        vec ? (rightmost ? find_seam_kernel<C, true, true>
                         : find_seam_kernel<C, true, false>)
            : (rightmost ? find_seam_kernel<C, false, true>
                         : find_seam_kernel<C, false, false>);
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        E, parents, seams, H, W, lo, width, lo0, width0);
    return static_cast<int>(cudaGetLastError());
  });
}
