// The per-shard kernels of the spatially sharded DP (parallel/spatial.py):
//
//   dc_block_dp       replaces dct_carver_tpu/pallas/spatial_dp_kernel.py::
//                     block_dp_rows (pl.pallas_call at :106, kernel
//                     _make_block_dp_kernel :51): K DP rows of a shard from
//                     the halo-gathered (Kb+1, We) message, row 0 the
//                     frontier;
//   dc_block_dp_parts replaces block_dp_parts_rows (:179,
//                     _make_block_dp_parts_kernel :122): the same rows built
//                     from four operands, the frontier (Wl), the energy block
//                     (Kb, Wl) and the left and right halos (Kb+1, Hh), read
//                     where they lie;
//   dc_seg_walk       replaces seg_walk_rows (:261, _make_seg_walk_kernel
//                     :221): the bottom-up tie-most walk of one K-row
//                     backtrack segment on the shard that owns its entry
//                     column.
//
// Every launch serves a stack of S shards of one image that lie side by side
// on one card: shard s owns global columns [lo + s*Wl, lo + (s+1)*Wl), and
// its halo-extended row holds global columns lo + s*Wl - Hh .. + We - 1,
// We = Wl + 2*Hh.  The logical width and the seam's entry column are read
// from device memory, so the host never waits for the card in the seam
// loop.
//
// What bounds them on an H100: latency.  A block is Kb dependent rows with a
// barrier each, one CTA a shard, and the K-row blocks of a seam run one
// after the other (each needs the last row of the one before, which the
// halo exchange between launches carries across shards).  At the 8K shard
// shape (Wl = 1920, K = 96, Hh = 192) a block moves ~3.5 MB for 4 shards,
// about a microsecond of bandwidth, against 96 rows of a few hundred
// nanoseconds each.  The walk is Kb dependent steps of one thread.
//
// Simple design.  The block DP keeps the frontier double-buffered in shared
// memory (2 * We floats: 18 KB at We = 2304), one barrier a row, and writes
// every row of M to device memory for the backtrack; cells outside [0,
// width) are +inf, and so are left of column 0 and right of column We-1,
// which stands in for the TPU's roll through a +inf lane tail.  Op order as
// ops/dp.py: m = e + min(min(left, centre), right), each op rounded on its
// own.  The walk stages its (Kb, 2K+1) window's parent directions in shared
// memory (int8, -1/0/+1 by dp_kernel.py::_parent_select's tie-most rule,
// as csrc/find_seam.cu), then one thread walks them; the window start is
// computed here from the entry column, which replaces JAX's dynamic_slice.
// The TPU's one-hot vector walk exists for its lane layout and is not
// copied.

#include <cuda_runtime.h>
#include <math.h>

namespace dct_carver {

constexpr int kBlockThreads = 1024;
constexpr int kWalkThreads = 256;

// #16: row r of the message; r = 0 is the frontier.
struct MessageRows {
  const float* msg;
  int We;
  __device__ __forceinline__ float at(int r, int j) const {
    return msg[static_cast<size_t>(r) * We + j];
  }
};

// #17: the same row assembled from its parts: [left halo | owned | right
// halo], the owned part from the frontier (r = 0) or the energy block.
struct PartRows {
  const float* prev;
  const float* E;
  const float* lh;
  const float* rh;
  int Wl;
  int Hh;
  __device__ __forceinline__ float at(int r, int j) const {
    if (j < Hh) return lh[r * Hh + j];
    j -= Hh;
    if (j < Wl) return r == 0 ? prev[j] : E[static_cast<size_t>(r - 1) * Wl + j];
    return rh[r * Hh + j - Wl];
  }
};

template <class Rows>
__device__ void block_rows(const Rows& src, float* __restrict__ out, int Kb,
                           int We, int col0, int width) {
  extern __shared__ float frontier[];
  float* prev = frontier;
  float* cur = frontier + We;
  const float inf = INFINITY;
  for (int j = threadIdx.x; j < We; j += blockDim.x) {
    const int c = col0 + j;
    prev[j] = (c >= 0 && c < width) ? src.at(0, j) : inf;
  }
  __syncthreads();
  for (int r = 0; r < Kb; ++r) {
    float* out_row = out + static_cast<size_t>(r) * We;
    for (int j = threadIdx.x; j < We; j += blockDim.x) {
      const int c = col0 + j;
      const float left = j > 0 ? prev[j - 1] : inf;
      const float right = j < We - 1 ? prev[j + 1] : inf;
      const float e = (c >= 0 && c < width) ? src.at(r + 1, j) : inf;
      const float m = __fadd_rn(e, fminf(fminf(left, prev[j]), right));
      cur[j] = m;
      out_row[j] = m;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
block_dp_kernel(const float* __restrict__ msg, float* __restrict__ out,
                long long out_ss, int Kb, int Wl, int Hh, int lo,
                const int* __restrict__ width) {
  const int s = blockIdx.x;
  const int We = Wl + 2 * Hh;
  const MessageRows src{msg + static_cast<size_t>(s) * (Kb + 1) * We, We};
  block_rows(src, out + s * out_ss, Kb, We, lo + s * Wl - Hh, *width);
}

__global__ void __launch_bounds__(kBlockThreads)
block_dp_parts_kernel(const float* __restrict__ prev, long long prev_ss,
                      const float* __restrict__ E, long long e_ss,
                      const float* __restrict__ lh,
                      const float* __restrict__ rh, float* __restrict__ out,
                      long long out_ss, int Kb, int Wl, int Hh, int lo,
                      const int* __restrict__ width) {
  const int s = blockIdx.x;
  const size_t halo = static_cast<size_t>(s) * (Kb + 1) * Hh;
  const PartRows src{prev + s * prev_ss, E + s * e_ss, lh + halo, rh + halo,
                     Wl, Hh};
  block_rows(src, out + s * out_ss, Kb, Wl + 2 * Hh, lo + s * Wl - Hh,
             *width);
}

// -1/0/+1: the tie-most minimum of (left, centre, right), as find_seam.cu.
__device__ __forceinline__ signed char parent(float left, float centre,
                                              float right, int rightmost) {
  if (!rightmost)
    return left <= centre ? (left <= right ? -1 : 1) : (centre <= right ? 0 : 1);
  return right <= centre ? (right <= left ? 1 : -1) : (centre <= left ? 0 : -1);
}

__global__ void __launch_bounds__(kWalkThreads)
seg_walk_kernel(const float* __restrict__ rows, long long rows_ss, int Kb,
                int Wl, int Hh, int K, int lo, const int* __restrict__ entry,
                int rightmost, int* __restrict__ seg) {
  extern __shared__ signed char par[];
  const int s = blockIdx.x;
  const int j = *entry;
  const int lo_s = lo + s * Wl;
  int* out = seg + static_cast<size_t>(s) * Kb;
  if (j < lo_s || j >= lo_s + Wl) {  // not the owner: its part of the psum
    for (int r = threadIdx.x; r < Kb; r += blockDim.x) out[r] = 0;
    return;
  }
  const float inf = INFINITY;
  const int We = Wl + 2 * Hh;
  const int ww = 2 * K + 1;
  const int wstart = min(max(j - lo_s + Hh - K, 0), We - ww);
  const float* win = rows + s * rows_ss + wstart;
  for (int e = threadIdx.x; e < Kb * ww; e += blockDim.x) {
    const int r = e / ww;
    const int w = e - r * ww;
    const float* row = win + static_cast<size_t>(r) * We;
    const float left = w > 0 ? row[w - 1] : inf;
    const float right = w < ww - 1 ? row[w + 1] : inf;
    par[e] = parent(left, row[w], right, rightmost);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int jl = K;  // the entry column, below the segment's last row
    for (int r = Kb - 1; r >= 0; --r) {
      jl += par[r * ww + min(max(jl, 0), ww - 1)];
      out[r] = jl + j - K;
    }
  }
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` pass the
// 48 KB default.
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int threads_for(int We) {
  return We < kBlockThreads ? ((We + 31) / 32) * 32 : kBlockThreads;
}

}  // namespace dct_carver

// msg: (S, Kb+1, We) f32, row 0 the frontier; out: row r of shard s at
// out + s*out_ss + r*We.  width: one int32 on the device.  Returns the
// cudaError_t of the attribute call or of the launch.
extern "C" int dc_block_dp(const float* msg, float* out, long long out_ss,
                           int S, int Kb, int Wl, int Hh, int lo,
                           const int* width, void* stream) {
  using namespace dct_carver;
  const int We = Wl + 2 * Hh;
  const size_t smem = 2 * static_cast<size_t>(We) * sizeof(float);
  if (const int err = allow_smem(block_dp_kernel, smem)) return err;
  block_dp_kernel<<<S, threads_for(We), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      msg, out, out_ss, Kb, Wl, Hh, lo, width);
  return static_cast<int>(cudaGetLastError());
}

// prev: shard s's frontier at prev + s*prev_ss (Wl f32); E: its energy
// block at E + s*e_ss (Kb rows of Wl); lh, rh: (S, Kb+1, Hh) f32; out as
// dc_block_dp.  Returns the cudaError_t of the attribute call or the launch.
extern "C" int dc_block_dp_parts(const float* prev, long long prev_ss,
                                 const float* E, long long e_ss,
                                 const float* lh, const float* rh, float* out,
                                 long long out_ss, int S, int Kb, int Wl,
                                 int Hh, int lo, const int* width,
                                 void* stream) {
  using namespace dct_carver;
  const int We = Wl + 2 * Hh;
  const size_t smem = 2 * static_cast<size_t>(We) * sizeof(float);
  if (const int err = allow_smem(block_dp_parts_kernel, smem)) return err;
  block_dp_parts_kernel<<<S, threads_for(We), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      prev, prev_ss, E, e_ss, lh, rh, out, out_ss, Kb, Wl, Hh, lo, width);
  return static_cast<int>(cudaGetLastError());
}

// rows: row r of shard s's M at rows + s*rows_ss + r*We, We = Wl + 2*Hh;
// entry: the global seam column below the last row (one int32 on the
// device); seg: (S, Kb) int32 out, the owner's global columns and 0
// elsewhere.  Returns the cudaError_t of the attribute call or the launch.
extern "C" int dc_seg_walk(const float* rows, long long rows_ss, int S,
                           int Kb, int Wl, int Hh, int K, int lo,
                           const int* entry, int rightmost, int* seg,
                           void* stream) {
  using namespace dct_carver;
  const size_t smem = static_cast<size_t>(Kb) * (2 * K + 1);
  if (const int err = allow_smem(seg_walk_kernel, smem)) return err;
  seg_walk_kernel<<<S, kWalkThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      rows, rows_ss, Kb, Wl, Hh, K, lo, entry, rightmost, seg);
  return static_cast<int>(cudaGetLastError());
}
