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
// What bounds it on an H100: latency, in waves of B CTAs.  Row r depends on
// row r-1, so each image's H rows run one after the other; each row is a
// short dependent chain plus one block-wide barrier.  The B images are
// independent CTAs: at W >= 1024 each CTA has 1024 threads and two fit an
// SM (__launch_bounds__ caps the registers at 32 a thread), so up to 264
// images run at once on 132 SMs and a batch takes ceil(B / 264) waves of
// one image's latency.  The bytes (E read once, int8 parents written once:
// 5 * B * H * W) are not the limit.
//
// Simple design: threads stride over the columns.  The frontier row is
// double-buffered in shared memory (2 * W floats; above 48 KB the entry
// point raises the dynamic shared-memory limit), so one __syncthreads() a
// row suffices.  Parents (-1/0/+1) go to an int8 (B, H, W) scratch in global
// memory with the tie-most rule of dp_kernel.py::_parent_select.  Then a
// block reduction finds the tie-most argmin of the last row, and thread 0
// walks the parents up.  The TPU's sublane packing of the batch and its
// one-hot backtrack exist for the VPU's layout and are not copied.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right).  Cells
// outside [lo_b, lo_b + width_b) are +inf; so are left of column 0 and right
// of column W-1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dct_carver {

constexpr int kThreads = 1024;

// True when (v, j) beats (bv, bj): a smaller value, or an equal value
// further towards the tie side.  bj < 0 marks "nothing yet".
__device__ __forceinline__ bool better(float v, int j, float bv, int bj,
                                       bool rightmost) {
  if (bj < 0) return true;
  if (v < bv) return true;
  if (v == bv) return rightmost ? j > bj : j < bj;
  return false;
}

__global__ void __launch_bounds__(kThreads, 2)
find_seam_kernel(const float* __restrict__ E_all,
                 int8_t* __restrict__ parents_all, int* __restrict__ seams,
                 int H, int W, const int* __restrict__ lo_arr,
                 const int* __restrict__ width_arr, int lo0, int width0,
                 int rightmost) {
  extern __shared__ float frontier[];
  float* prev = frontier;
  float* cur = frontier + W;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_j[kThreads / 32];
  const float inf = INFINITY;
  // image b's planes; the row pointers advance by W a row, so the loop
  // body's addresses stay one add off a pointer
  const size_t image = static_cast<size_t>(blockIdx.x) * H * W;
  const float* e_row = E_all + image;
  int8_t* p_row = parents_all + image;
  int* seam = seams + static_cast<size_t>(blockIdx.x) * H;
  const int lo = lo_arr ? lo_arr[blockIdx.x] : lo0;
  const int hi = lo + (width_arr ? width_arr[blockIdx.x] : width0);

  for (int j = threadIdx.x; j < W; j += blockDim.x)
    prev[j] = (j >= lo && j < hi) ? e_row[j] : inf;
  __syncthreads();

  for (int row = 1; row < H; ++row) {
    e_row += W;
    p_row += W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const float left = j > 0 ? prev[j - 1] : inf;
      const float centre = prev[j];
      const float right = j < W - 1 ? prev[j + 1] : inf;
      const float e = (j >= lo && j < hi) ? e_row[j] : inf;
      cur[j] = __fadd_rn(e, fminf(fminf(left, centre), right));
      int p;
      if (!rightmost)
        p = left <= centre ? (left <= right ? -1 : 1) : (centre <= right ? 0 : 1);
      else
        p = right <= centre ? (right <= left ? 1 : -1) : (centre <= left ? 0 : -1);
      p_row[j] = static_cast<int8_t>(p);
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  // tie-most argmin of the last row (cells outside the window hold +inf)
  float bv = inf;
  int bj = -1;
  for (int j = threadIdx.x; j < W; j += blockDim.x)
    if (better(prev[j], j, bv, bj, rightmost)) {
      bv = prev[j];
      bj = j;
    }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    if (oj >= 0 && better(ov, oj, bv, bj, rightmost)) {
      bv = ov;
      bj = oj;
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red_v[warp] = bv;
    red_j[warp] = bj;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bv = red_v[0];
    bj = red_j[0];
    for (int w = 1; w < (blockDim.x + 31) / 32; ++w)
      if (red_j[w] >= 0 && better(red_v[w], red_j[w], bv, bj, rightmost)) {
        bv = red_v[w];
        bj = red_j[w];
      }
    // backtrack: row 0's parents are never read
    int j = bj;
    seam[H - 1] = j;
    for (int row = H - 1; row > 0; --row) {
      j += p_row[j];
      p_row -= W;
      seam[row - 1] = j;
    }
  }
}

}  // namespace dct_carver

// E: (B, H, W) f32 row-major; parents: (B, H, W) int8 scratch; seams: (B, H)
// int32 out.  Image b's DP runs over the column window [lo_b, lo_b +
// width_b), read from lo[b] and width[b] (int32 arrays on the device), or
// lo0 and width0 for every image where the pointer is null.  Returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int dc_find_seams(const float* E, int8_t* parents, int* seams,
                             int B, int H, int W, const int* lo,
                             const int* width, int lo0, int width0,
                             int rightmost, void* stream) {
  using namespace dct_carver;
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        find_seam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = W < kThreads ? ((W + 31) / 32) * 32 : kThreads;
  find_seam_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      E, parents, seams, H, W, lo, width, lo0, width0, rightmost);
  return static_cast<int>(cudaGetLastError());
}
