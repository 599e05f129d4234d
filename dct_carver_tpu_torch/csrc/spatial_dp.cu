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
// about a microsecond of bandwidth, against 96 dependent rows.  The walk
// reads ~75 KB and does Kb dependent steps of one thread: its time is one
// trip to device memory (in the carve its rows have left the 50 MB L2: the
// seam's M is 4 x 4320 x 2304 f32 = 159 MB) plus Kb steps of shared-memory
// latency.
//
// Design.  The block DP runs the chunked row step of dp_rows.cuh (each
// thread C contiguous columns of the extended row in registers, only the
// chunk's edge cells through shared memory, one barrier a row).  Each
// extended row is assembled ahead of the recurrence: the threads copy its
// 4-column groups from wherever they lie (the message, or the left halo,
// the energy block and the right halo of the parts form: the three-way
// choice is made while staging) with cp.async into a ring of kStages rows
// in shared memory, so the row step reads one buffer and waits for no
// load.  Every row of M goes to device memory for the
// backtrack; cells outside [0, width) are +inf, and so are left of column 0
// and right of column We-1, which stands in for the TPU's roll through a
// +inf lane tail.  Op order as ops/dp.py: m = e + min(min(left, centre),
// right), each op rounded on its own.
//
// The walk launches one CTA a shard; every CTA but the owner of the entry
// column writes its zeros and exits.  The owner computes the window start
// from the entry column (this replaces JAX's dynamic_slice), aligns it down
// to 4 columns, and stages the window's f32 rows, kWalkRows-row chunks from
// the bottom up, into a ring of up to kWalkDepth chunk slots in shared
// memory: each warp takes a row, its lanes 16-byte cp.async copies along
// it (4-byte copies where rows are not 16-byte aligned), and every chunk
// the ring holds is in flight before the walk waits for the first, so the
// window costs about one trip to device memory, and a chunk that had to
// wait for a free slot loads under the walk of the chunks before it.  One
// thread then walks each chunk as it lands: three shared-memory reads a
// row around the current column and the tie-most rule of parent() (+inf
// outside the window), with no parent plane computed ahead.  The TPU's
// one-hot vector walk exists for its lane layout and is not copied.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "dp_rows.cuh"

namespace dct_carver {

constexpr int kWalkThreads = 256;

// #16: row r of the message; r = 0 is the frontier.
struct MessageRows {
  const float* msg;
  int We;
  __device__ __forceinline__ const float* at(int r, int j) const {
    return msg + static_cast<size_t>(r) * We + j;
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
  __device__ __forceinline__ const float* at(int r, int j) const {
    if (j < Hh) return lh + r * Hh + j;
    j -= Hh;
    if (j < Wl) return r == 0 ? prev + j : E + static_cast<size_t>(r - 1) * Wl + j;
    return rh + r * Hh + j - Wl;
  }
};

// Moves the rows of one shard for dp_rows: extended rows in, each column
// from wherever `Rows` says it lies; rows of M out (row k of the recurrence
// is row k - 1 of out), 16 bytes at a time when out's rows allow it.
template <class Rows>
struct BlockIo {
  Rows src;
  float* out;
  int We;
  bool vec;
  __device__ __forceinline__ void load(int k, float* dst, int c) const {
    const float* from = src.at(k, c);
    // one 16-byte copy where the group lies in one source, aligned
    if (c + 3 < We && src.at(k, c + 3) == from + 3
        && reinterpret_cast<uintptr_t>(from) % 16 == 0) {
      cp_async16(dst, from);
      return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < We) cp_async4(dst + i, src.at(k, c + i));
  }
  __device__ __forceinline__ void store(int k, float4 v, int c) const {
    float* to = out + static_cast<size_t>(k - 1) * We + c;
    if (vec) {
      *reinterpret_cast<float4*>(to) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < We) to[i] = f[i];
    }
  }
};

// Kb DP rows of one shard from rows 0 .. Kb of `src` (row 0 the frontier)
// into out (row r at out + r*We); extended column j is global column
// col0 + j, live when inside [0, width).
template <int C, class Rows>
__device__ void block_rows(const Rows& src, float* __restrict__ out, int Kb,
                           int We, int col0, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = threadIdx.x * C;
  const Window win(-col0, min(width - col0, We), j0, C);
  float m[C];
#pragma unroll
  for (int i = 0; i < C; ++i)
    m[i] = win.has(i) ? *src.at(0, j0 + i) : INFINITY;
  const bool vec = We % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dp_rows<C, false, false>(BlockIo<Rows>{src, out, We, vec}, m, Kb, We, win,
                           smem);
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
block_dp_kernel(const float* __restrict__ msg, float* __restrict__ out,
                long long out_ss, int Kb, int Wl, int Hh, int lo,
                const int* __restrict__ width) {
  const int s = blockIdx.x;
  const int We = Wl + 2 * Hh;
  const MessageRows src{msg + static_cast<size_t>(s) * (Kb + 1) * We, We};
  block_rows<C>(src, out + s * out_ss, Kb, We, lo + s * Wl - Hh, *width);
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
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
  block_rows<C>(src, out + s * out_ss, Kb, Wl + 2 * Hh, lo + s * Wl - Hh,
                *width);
}

// -1/0/+1: the tie-most minimum of (left, centre, right), as find_seam.cu.
__device__ __forceinline__ signed char parent(float left, float centre,
                                              float right, int rightmost) {
  if (!rightmost)
    return left <= centre ? (left <= right ? -1 : 1) : (centre <= right ? 0 : 1);
  return right <= centre ? (right <= left ? 1 : -1) : (centre <= left ? 0 : -1);
}

// Wait until at most n of this thread's copy groups are in flight, n <
// kWalkDepth.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The walk's ring: chunks of kWalkRows rows, each row `pitch` floats, at
// most kWalkDepth chunks in flight.
constexpr int kWalkRows = 16;
constexpr int kWalkDepth = 8;
constexpr size_t kSmemMax = 232448;  // one block's shared memory

inline int walk_pitch(int K) { return (2 * K + 1 + 3 + 3) / 4 * 4; }

__global__ void __launch_bounds__(kWalkThreads)
seg_walk_kernel(const float* __restrict__ rows, long long rows_ss, int Kb,
                int Wl, int Hh, int K, int lo, const int* __restrict__ entry,
                int rightmost, int pitch, int depth, int* __restrict__ seg) {
  extern __shared__ __align__(16) float ring[];
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
  // staged columns [a0, a0 + ncols): the window, 4-column aligned
  const int a0 = wstart & ~3;
  const int ncols = (wstart + ww - a0 + 3) & ~3;
  const float* shard = rows + s * rows_ss;
  const float* src0 = shard + a0;
  const bool vec =
      We % 4 == 0 && reinterpret_cast<uintptr_t>(shard) % 16 == 0;
  const int nchunks = (Kb + kWalkRows - 1) / kWalkRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;

  // chunk c: rows [r1 - kWalkRows, r1) clipped at 0, r1 = Kb - c*kWalkRows;
  // row r at slot row r1 - 1 - r
  auto stage = [&](int c) {
    const int r1 = Kb - c * kWalkRows;
    const int r0 = max(r1 - kWalkRows, 0);
    float* slot = ring + static_cast<size_t>(c % depth) * kWalkRows * pitch;
    for (int r = r1 - 1 - warp; r >= r0; r -= warps) {
      const float* src = src0 + static_cast<size_t>(r) * We;
      float* dst = slot + (r1 - 1 - r) * pitch;
      for (int g = 4 * lane; g < ncols; g += 128) {
        if (vec) {
          cp_async16(dst + g, src + g);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (a0 + g + i < We) cp_async4(dst + g + i, src + g + i);
        }
      }
    }
  };

  for (int c = 0; c < depth; ++c) {
    if (c < nchunks) stage(c);
    cp_async_commit();
  }
  int jl = K;  // the entry column, below the segment's last row
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_n(depth - 1);  // chunk c has landed
    __syncthreads();
    if (threadIdx.x == 0) {
      const int r1 = Kb - c * kWalkRows;
      const int r0 = max(r1 - kWalkRows, 0);
      const float* win = ring + static_cast<size_t>(c % depth) * kWalkRows
                         * pitch + (wstart - a0);
      for (int r = r1 - 1; r >= r0; --r) {
        const float* row = win + (r1 - 1 - r) * pitch;
        const int w = min(max(jl, 0), ww - 1);
        const float left = w > 0 ? row[w - 1] : inf;
        const float right = w < ww - 1 ? row[w + 1] : inf;
        jl += parent(left, row[w], right, rightmost);
        out[r] = jl + j - K;
      }
    }
    __syncthreads();  // slot c % depth is free
    if (c + depth < nchunks) stage(c + depth);
    cp_async_commit();
  }
}

// Launch block kernel `kernel<C>` over S shards with the chunk width and
// CTA that the extended row's We columns take.
template <class Launch>
int launch_rows(int We, Launch go) {
  return with_chunk(We, [&](auto c) {
    constexpr int C = decltype(c)::value;
    const int threads = threads_for<C>(We);
    return go(c, threads, ring_bytes<C>(threads));
  });
}

}  // namespace dct_carver

// msg: (S, Kb+1, We) f32, row 0 the frontier; out: row r of shard s at
// out + s*out_ss + r*We.  width: one int32 on the device.  We <= 32768.
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int dc_block_dp(const float* msg, float* out, long long out_ss,
                           int S, int Kb, int Wl, int Hh, int lo,
                           const int* width, void* stream) {
  using namespace dct_carver;
  return launch_rows(Wl + 2 * Hh, [&](auto c, int threads, size_t smem) {
    const auto kernel = block_dp_kernel<decltype(c)::value>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        msg, out, out_ss, Kb, Wl, Hh, lo, width);
    return static_cast<int>(cudaGetLastError());
  });
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
  return launch_rows(Wl + 2 * Hh, [&](auto c, int threads, size_t smem) {
    const auto kernel = block_dp_parts_kernel<decltype(c)::value>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        prev, prev_ss, E, e_ss, lh, rh, out, out_ss, Kb, Wl, Hh, lo, width);
    return static_cast<int>(cudaGetLastError());
  });
}

// rows: row r of shard s's M at rows + s*rows_ss + r*We, We = Wl + 2*Hh;
// entry: the global seam column below the last row (one int32 on the
// device); seg: (S, Kb) int32 out, the owner's global columns and 0
// elsewhere.  Takes any K whose kWalkRows-row chunk of 2K+1 (+6) columns
// fits one block's shared memory.  Returns the cudaError_t of the attribute
// call or the launch.
extern "C" int dc_seg_walk(const float* rows, long long rows_ss, int S,
                           int Kb, int Wl, int Hh, int K, int lo,
                           const int* entry, int rightmost, int* seg,
                           void* stream) {
  using namespace dct_carver;
  const int pitch = walk_pitch(K);
  const size_t chunk = static_cast<size_t>(kWalkRows) * pitch * sizeof(float);
  const int nchunks = std::max((Kb + kWalkRows - 1) / kWalkRows, 1);
  const int depth = static_cast<int>(
      std::min<size_t>(std::min(nchunks, kWalkDepth), kSmemMax / chunk));
  if (depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = depth * chunk;
  if (const int err = allow_smem(seg_walk_kernel, smem)) return err;
  seg_walk_kernel<<<S, kWalkThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      rows, rows_ss, Kb, Wl, Hh, K, lo, entry, rightmost, pitch, depth, seg);
  return static_cast<int>(cudaGetLastError());
}
