// Find one vertical seam: the masked min-plus DP forward, the argmin of the
// last row, and the backtrack, in one kernel of one thread block.
//
// Replaces dct_carver_tpu/pallas/dp_kernel.py::_fused_find_seam_batched
// (the pl.pallas_call at :348, body _make_fused_seam_kernel :212 /
// _fused_seam_body :249), reached through find_seam_pallas :572.  The same
// kernel covers the TPU's other routes of that function (dp_forward :124,
// dp_backtrack :184 and the folded pair at :523/:553), which exist only
// because of the TPU's VMEM size and lane layout.
//
// What bounds it on an H100: latency.  Row r depends on row r-1, so the H
// rows run one after the other; each row is a short dependent chain plus
// one block-wide barrier.  The bytes (E read once, int8 parents written
// once: 5 * H * W) are not the limit.
//
// Simple design: one CTA, threads striding over the columns.  The frontier
// row is double-buffered in shared memory (2 * W floats; above 48 KB the
// wrapper raises the dynamic shared-memory limit), so one __syncthreads()
// a row suffices.  Parents (-1/0/+1) go to an int8 (H, W) scratch in global
// memory with the tie-most rule of dp_kernel.py::_parent_select.  Then a
// block reduction finds the tie-most argmin of the last row, and thread 0
// walks the parents up.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right).  Cells
// outside [lo, lo + width) are +inf; so are left of column 0 and right of
// column W-1.

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

__global__ void __launch_bounds__(kThreads)
find_seam_kernel(const float* __restrict__ E, int8_t* __restrict__ parents,
                 int* __restrict__ seam, int H, int W, int lo, int width,
                 int rightmost) {
  extern __shared__ float frontier[];
  float* prev = frontier;
  float* cur = frontier + W;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_j[kThreads / 32];
  const float inf = INFINITY;
  const int hi = lo + width;

  for (int j = threadIdx.x; j < W; j += blockDim.x)
    prev[j] = (j >= lo && j < hi) ? E[j] : inf;
  __syncthreads();

  for (int row = 1; row < H; ++row) {
    const float* e_row = E + static_cast<size_t>(row) * W;
    int8_t* p_row = parents + static_cast<size_t>(row) * W;
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
      j += parents[static_cast<size_t>(row) * W + j];
      seam[row - 1] = j;
    }
  }
}

}  // namespace dct_carver

// E: (H, W) f32 row-major; parents: (H, W) int8 scratch; seam: (H,) int32
// out.  The DP runs over the column window [lo, lo + width).  Returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int dc_find_seam(const float* E, int8_t* parents, int* seam, int H,
                            int W, int lo, int width, int rightmost,
                            void* stream) {
  using namespace dct_carver;
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        find_seam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = W < kThreads ? ((W + 31) / 32) * 32 : kThreads;
  find_seam_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      E, parents, seam, H, W, lo, width, rightmost);
  return static_cast<int>(cudaGetLastError());
}
