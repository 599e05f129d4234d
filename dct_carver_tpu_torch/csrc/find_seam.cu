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
// the TPU's other single-image routes (dp_forward :124, dp_backtrack :184
// and the folded pair at :523/:553), which exist only because of the TPU's
// VMEM size and lane layout.
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
// shared memory, one barrier a row.  The CTA is ceil(W / C) threads, with C
// the narrowest chunk that keeps it within 256 threads up to W = 4096 (512
// above), so at the batch route's W = 1024 several images share an SM.
// Energy rows are staged kStages - 1 rows ahead with coalesced cp.async
// copies (16 bytes when rows are 16-byte aligned, else 4) into a ring in
// shared memory, and the column window [lo_b, lo_b + width_b) is applied
// when a value is used.  Parents (-1/0/+1, the tie-most rule of
// dp_kernel.py::_parent_select) are packed four to a word into the ring
// slot of the row and copied out, coalesced, one row later, to an int8
// (B, H, Wp) scratch, Wp = W rounded up to 4.  A block reduction finds the
// tie-most argmin of the last row.  The backtrack walks kSegRows rows at a
// time: a seam moves at most one column a row, so below column j the next
// kSegRows rows stay inside [j - kSegRows, j + kSegRows]; all threads copy
// that window of parents (clamped to [0, W)) into shared memory in one
// round trip, then thread 0 walks it.  The TPU's sublane packing of the
// batch and its one-hot backtrack exist for the VPU's layout and are not
// copied.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right).  Cells
// outside [lo_b, lo_b + width_b) are +inf; so are left of column 0 and right
// of column W-1.

#include <algorithm>

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
  __shared__ float red_v[32];
  __shared__ int red_j[32];
  __shared__ int s_j;
  const float inf = INFINITY;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int j0 = t * C;
  const size_t b = blockIdx.x;
  const float* E = E_all + b * H * W;
  const int Wp = parent_pitch(W);
  int8_t* P = parents_all + b * H * Wp;
  int* seam = seams + b * H;
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
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    if (oj >= 0 && better<RIGHTMOST>(ov, oj, bv, bj)) {
      bv = ov;
      bj = oj;
    }
  }
  const int warp = t / 32;
  const int lane = t % 32;
  const int warps = T / 32;
  if (lane == 0) {
    red_v[warp] = bv;
    red_j[warp] = bj;
  }
  __syncthreads();
  if (t == 0) {
    bv = red_v[0];
    bj = red_j[0];
    for (int w = 1; w < warps; ++w)
      if (red_j[w] >= 0 && better<RIGHTMOST>(red_v[w], red_j[w], bv, bj)) {
        bv = red_v[w];
        bj = red_j[w];
      }
    seam[H - 1] = bj;
    s_j = bj;
  }
  __syncthreads();

  // windowed backtrack; the window aliases the ring, which is done with.
  // Row 0's parents are never read.  The window's rows are copied as
  // aligned 32-bit words, all issued before one wait: one round trip.
  int8_t* win_s = reinterpret_cast<int8_t*>(smem);
  const int ww = min(2 * kSegRows + 1, W);
  int j = s_j;
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

// E: (B, H, W) f32 row-major; parents: (B, H, Wp) int8 scratch, Wp = W
// rounded up to a multiple of 4; seams: (B, H) int32 out.  Image b's DP runs
// over the column window [lo_b, lo_b + width_b), read from lo[b] and
// width[b] (int32 arrays on the device), or lo0 and width0 for every image
// where the pointer is null.  W <= 32768.  Returns the cudaError_t of the
// attribute call or of the launch.
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
