// Find one vertical seam in each of B images by the masked min-plus DP over
// column tiles, one warp a tile: the forward in K-row blocks, then the
// argmin of the last row and the backtrack.
//
// Replaces dct_carver_tpu/pallas/dp_kernel.py's streamed route, which takes
// any width: dp_forward (the pl.pallas_call at :124, kernel
// _make_dp_forward_kernel :70) writing the parents and the last DP row to
// HBM row block by row block, the argmin, and dp_backtrack (:184, kernel
// _backtrack_kernel :148), chosen at :596-607.
//
// What bounds it on an H100: latency, twice over.  Row r depends on row
// r-1, so a tile's rows run one after the other; one CTA a row
// (find_seam.cu) pays a barrier over all its warps every row.  Here a tile
// is one warp and a row needs no barrier, only two shuffles, so a row costs
// the cycles one warp takes to send out its instructions (edges, minimums,
// adds, parent bytes, the staging and the stores).  Then a block costs a round trip
// between warps: a tile's halo columns come from its neighbours' last row
// of the block before, so each block ends with stores that the neighbours
// wait to see through the L2.  K rows a block amortise it; the halo of
// Hh >= K columns a side that keeps a block's owned values exact costs
// compute, which a latency-bound row has to spare.
//
// Design.  Lane l owns the C contiguous columns [l*C, l*C + C) of an
// extended row of at most 32*C columns: Wt owned columns and Hh = K rounded
// up to 4 halo columns a side (Hh <= Wt, so the halo reaches only the two
// neighbouring tiles; lanes past Wt + 2*Hh hold +inf).  Each row the lane
// takes its neighbours' edge cells with __shfl_up_sync/__shfl_down_sync
// (+inf beyond lanes 0 and 31) and runs chunk_row (dp_rows.cuh), the op
// order m = e + min(min(left, centre), right) with __fadd_rn and the
// tie-most parent_byte; a tile whose lanes all lie in the image's column
// window skips the window's test.  A value |dc| columns from the extended
// row's ends is exact for |dc| rows (parallel/spatial.py :15-19's
// argument), so the owned columns are exact for all K rows of a block that
// starts from exact values on the whole extended row.  Each lane stages its
// own energy columns by cp.async into a per-lane ring of shared memory,
// kStages - 1 rows ahead (16 bytes a lane a row at C = 4); a lane reads
// only what it copied, so the ring needs cp.async.wait_group and no
// barrier.  The rows are unrolled kStages at a time, so every ring slot is
// a constant; the staging's addresses advance by a pointer a row, and the
// tile's column, window and owned words are worked out once a block.
// Parents go out as one packed 32-bit word per 4 owned columns a row (128 B
// a warp a row at C = 4), into the same (B, H, Wp) int8 scratch as
// find_seam.cu; the parents of halo columns are never stored.
//
// One launch runs every block of every tile.  The grid is cooperative
// (cudaLaunchCooperativeKernel) and at most as large as the occupancy API
// says is resident, so every warp whose cells a warp waits for is running:
// a grid that cannot be resident is a launch error, not a hang.  Under a
// CUDA graph's stream capture (the carve's seam step, ops/carve.py) the
// launch becomes a cooperative kernel node and the frontier's memset a
// memset node; CUDA 12.8 accepts both (chip_smoke.py phase 2 replays such
// graphs and holds their seams against the plain DP).  Where
// there are more tiles (B x ceil(W / Wt)) than resident warps, each warp
// owns a run of adjacent tiles and does block k of all of them before
// block k + 1.
//
// The frontier has one slice a block, front[k] (B, W): after block k a
// tile stores its owned part of the block's last row there as 64-bit cells
// (the value in the low half, k + 1 in the high half) with
// st.relaxed.gpu, then stages the first rows of its next segment.  To
// start block k + 1 a lane loads the cells of its extended row from
// front[k] with ld.relaxed.gpu until each one's tag reads k + 1, so it
// waits for exactly the neighbours' columns it needs.  No race:
//   - Read after write: an aligned 64-bit access is single-copy atomic, so
//     a cell whose tag reads k + 1 holds the value its writer stored with
//     it; no other data is read across warps (the parents go to the
//     finish, a later launch).
//   - Write after read: none; each cell is written once a call.  One
//     memset clears every slice first (tag 0: no block wrote it).
// A last launch, one CTA an image, takes the tie-most argmin of the last
// block's slice and walks the parents up (seam_walk.cuh, shared with
// find_seam.cu).  A call with H >= 2 is three launches: the frontier's
// memset, the forward and the finish; with H = 1 only the finish.
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
constexpr int kMaxTileWarps = 8;  // warp-tiles a CTA at most
constexpr int kMaxDevices = 64;   // cards whose occupancy is kept

// A warp-tile's staging ring: kStages rows of 32 lanes, each lane's C
// columns kPitch floats apart (dp_rows.cuh's bank-conflict-free pitch):
// 8 KB (C = 4) or 24 KB (C = 8) a warp.
template <int C>
struct WarpRing {
  static_assert(C == 4 || C == 8, "a warp-tile has 4 or 8 columns a lane");
  static constexpr int kStages = 16;
  static constexpr int kPitch = Chunk<C>::kPitch;
  static constexpr int kSlot = 32 * kPitch;  // floats a slot
  static constexpr size_t kBytes = sizeof(float) * kStages * kSlot;
};

// A frontier cell: a DP value and the number of the block whose last row
// it is, in one 64-bit word, so that one relaxed access moves both.
__device__ __forceinline__ void store_cell(unsigned long long* p, float v,
                                           int tag) {
  const unsigned long long w =
      static_cast<unsigned long long>(static_cast<unsigned>(tag)) << 32 |
      __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_cell(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// The geometry every warp of a launch shares.
struct Tiling {
  int B, H, W;
  int tiles;   // tiles an image: ceil(W / Wt)
  int Wt;      // owned columns a tile
  int Hh;      // halo columns a side
  int K;       // rows a block
  int blocks;  // ceil((H - 1) / K)
  int run;     // tiles a warp
};

// One lane's staging of a segment (block k of tile g): its columns of the
// block's row 0 in the energy plane (row n is n * W floats on), and the
// column of its first one.
struct Segment {
  const float* src;
  int c0;
  __device__ Segment(const float* E_all, const Tiling& t, int k, int g,
                     int j0) {
    const int b = g / t.tiles;
    c0 = (g - b * t.tiles) * t.Wt - t.Hh + j0;
    src = E_all + (static_cast<long long>(b) * t.H + k * t.K) * t.W + c0;
  }
};

// cp.async this lane's columns of one energy row (src, first column c0)
// to dst; columns outside [0, W), and lanes past the extended row (j0 >=
// We), copy nothing.
template <int C, bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* src, int c0,
                                      int W, bool lane_in) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const int c = c0 + 4 * q;
    if (VEC) {
      // c is a multiple of 4 and so is W: the group is inside or outside
      if (lane_in && c >= 0 && c < W) cp_async16(dst + 4 * q, src + 4 * q);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane_in && c + i >= 0 && c + i < W)
          cp_async4(dst + 4 * q + i, src + 4 * q + i);
    }
  }
}

// The forward: every block of every tile of warp (blockIdx.x * warps a CTA
// + warp in the CTA)'s run [g_lo, g_hi) of the B * tiles tiles.  Rows are
// staged D - 1 ahead within a segment (block k of tile g); a segment's
// first D - 1 rows are staged as the segment before it ends, after its
// frontier cells are out, so that they land while the next block waits
// for its neighbours' cells.  Every row commits one cp.async group (empty
// past the segment's end), and a segment's first D - 1 rows are D - 1
// groups: row n of a segment is then its n-th group, in ring slot
// (n - 1) % D, a constant once the rows are unrolled D at a time.
template <int C, bool VEC, bool RIGHTMOST>
__global__ void __launch_bounds__(32 * kMaxTileWarps)
tile_rows_kernel(const float* __restrict__ E_all, unsigned long long* front,
                 int8_t* __restrict__ parents_all, Tiling t,
                 const int* __restrict__ lo_arr,
                 const int* __restrict__ width_arr, int lo0, int width0) {
  using Ring = WarpRing<C>;
  constexpr int D = Ring::kStages;
  constexpr int SL = Ring::kSlot;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned all = 0xffffffffu;
  const float inf = INFINITY;
  const int lane = threadIdx.x & 31;
  const int warp_in_cta = threadIdx.x >> 5;
  const int warp = blockIdx.x * (blockDim.x >> 5) + warp_in_cta;
  const int G = t.B * t.tiles;
  const int g_lo = warp * t.run;
  if (g_lo >= G) return;  // the whole warp: no tile
  const int g_hi = min(g_lo + t.run, G);
  const int We = t.Wt + 2 * t.Hh;
  const int W = t.W;
  const int Wp = parent_pitch(W);
  const int j0 = lane * C;
  const bool lane_in = j0 < We;
  const size_t BW = static_cast<size_t>(t.B) * W;
  float* const ring = reinterpret_cast<float*>(smem) +
                      warp_in_cta * D * SL + lane * Ring::kPitch;

  // rows 1 .. min(D - 1, N) of segment s into slots 0 .. D - 2
  const auto prologue = [&](const Segment& s, int N) {
#pragma unroll
    for (int n = 1; n < D; ++n) {
      if (n <= N) stage<C, VEC>(ring + (n - 1) * SL, s.src + n * W, s.c0,
                                W, lane_in);
      cp_async_commit();
    }
  };

  Segment seg(E_all, t, 0, g_lo, j0);
  prologue(seg, min(t.K, t.H - 1));
  for (int k = 0; k < t.blocks; ++k) {
    const int r0 = k * t.K;
    const int N = min(t.K, t.H - 1 - r0);
    for (int g = g_lo; g < g_hi; ++g) {
      const int b = g / t.tiles;
      const int col0 = seg.c0 - j0;
      const int lo = lo_arr ? lo_arr[b] : lo0;
      const int hi = min(lo + (width_arr ? width_arr[b] : width0), W);
      const Window win(lo - col0, min(hi - col0, We), j0, C);
      // the block's row 0: the energy's row 0, then block k - 1's last row,
      // each cell once its tag says block k - 1 wrote it
      float m[C];
      if (k == 0) {
        const float* f =
            E_all + static_cast<long long>(b) * t.H * W + seg.c0;
#pragma unroll
        for (int i = 0; i < C; ++i) m[i] = win.has(i) ? __ldcg(f + i) : inf;
      } else {
        const unsigned long long* f =
            front + (k - 1) * BW + static_cast<long long>(b) * W + seg.c0;
        unsigned need = 0;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          m[i] = inf;
          if (win.has(i)) need |= 1u << i;
        }
        while (need) {  // all of the lane's loads in flight at once
          unsigned long long w[C];
#pragma unroll
          for (int i = 0; i < C; ++i)
            w[i] = need >> i & 1u ? load_cell(f + i) : 0ull;
#pragma unroll
          for (int i = 0; i < C; ++i)
            if (need >> i & 1u && static_cast<int>(w[i] >> 32) == k) {
              m[i] = __uint_as_float(static_cast<unsigned>(w[i]));
              need &= ~(1u << i);
            }
        }
      }
      bool own[C / 4];  // which of the lane's words of parents it stores
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const int c = j0 + 4 * q;
        own[q] = c >= t.Hh && c < t.Hh + t.Wt && col0 + c < W;
      }
      int8_t* P = parents_all + (static_cast<long long>(b) * t.H + r0) * Wp
                  + seg.c0;
      const float* psrc = seg.src + D * W;  // row n + D - 1 at n = 1
      // rows 1 .. N; interior tiles, whose lanes all lie in the window,
      // skip its test
      const auto rows = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        for (int n0 = 0; n0 < N; n0 += D) {
#pragma unroll
          for (int j = 0; j < D; ++j) {
            const int n = n0 + j + 1;
            if (n > N) break;
            if (n + D - 1 <= N)
              stage<C, VEC>(ring + ((j + D - 1) % D) * SL, psrc, seg.c0, W,
                            lane_in);
            cp_async_commit();
            psrc += W;
            float left = __shfl_up_sync(all, m[C - 1], 1);
            float right = __shfl_down_sync(all, m[0], 1);
            if (lane == 0) left = inf;
            if (lane == 31) right = inf;
            cp_async_wait<D - 1>();  // row n has landed
            uint32_t o[C / 4];
            chunk_row<C, true, RIGHTMOST, MASKED>(m, ring + j * SL, win, left,
                                                  right, o);
            P += Wp;
#pragma unroll
            for (int q = 0; q < C / 4; ++q)
              if (own[q]) *reinterpret_cast<uint32_t*>(P + 4 * q) = o[q];
          }
        }
      };
      if (__all_sync(all, win.a == 0 && win.b == C))
        rows(std::false_type{});
      else
        rows(std::true_type{});
      // the owned part of the block's last row, tagged k + 1: the next
      // block's row 0, or the finish's last row
      unsigned long long* fn =
          front + k * BW + static_cast<long long>(b) * W + seg.c0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = j0 + i;
        if (c >= t.Hh && c < t.Hh + t.Wt && col0 + c < W)
          store_cell(fn + i, m[i], k + 1);
      }
      // stage the next segment's first rows
      const bool last = g + 1 == g_hi;
      const int kn = last ? k + 1 : k;
      if (kn < t.blocks) {
        seg = Segment(E_all, t, kn, last ? g_lo : g + 1, j0);
        prologue(seg, min(t.K, t.H - 1 - kn * t.K));
      }
    }
  }
  cp_async_wait<0>();
}

// The tie-most argmin of each image's last DP row F (through its window;
// column c at F[c * f_step]) and the backtrack over its parents; one CTA
// an image.
template <bool RIGHTMOST>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ F, long long f_stride, int f_step,
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
    const float v = c >= lo && c < hi ? f[c * f_step] : INFINITY;
    if (better<RIGHTMOST>(v, c, bv, bj)) {
      bv = v;
      bj = c;
    }
  }
  walk_back(parents_all + static_cast<size_t>(b) * H * parent_pitch(W), H, W,
            block_argmin<RIGHTMOST>(bv, bj),
            seams + static_cast<size_t>(b) * H, win_s);
}

template <int C, bool VEC, bool RIGHTMOST>
int launch_forward(const float* E, unsigned long long* front,
                   int8_t* parents, Tiling t, const int* lo, const int* width,
                   int lo0, int width0, int warps, int max_warps,
                   cudaStream_t s) {
  const auto kernel = tile_rows_kernel<C, VEC, RIGHTMOST>;
  const int threads = 32 * warps;
  const size_t smem = warps * WarpRing<C>::kBytes;
  // every warp whose cells another waits for must be resident.  The count
  // (and the shared-memory limit it needs) is asked of the runtime once a
  // (device, warps) and kept, so a call makes no host queries.
  static long long resident_by[kMaxDevices][kMaxTileWarps + 1] = {};
  int dev = 0;
  if (const int e = static_cast<int>(cudaGetDevice(&dev))) return e;
  long long resident = dev < kMaxDevices ? resident_by[dev][warps] : 0;
  if (resident == 0) {
    if (const int e = allow_smem(kernel, smem)) return e;
    int sms = 0, per_sm = 0;
    if (const int e = static_cast<int>(cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev)))
      return e;
    if (const int e = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem)))
      return e;
    resident = static_cast<long long>(per_sm) * sms * warps;
    if (dev < kMaxDevices) resident_by[dev][warps] = resident;
  }
  if (max_warps > 0) resident = std::min<long long>(resident, max_warps);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long G = static_cast<long long>(t.B) * t.tiles;
  t.run = static_cast<int>((G + resident - 1) / resident);
  const long long used = (G + t.run - 1) / t.run;
  const int ctas = static_cast<int>((used + warps - 1) / warps);
  // tag 0 marks a cell no block has written
  if (const int e = static_cast<int>(cudaMemsetAsync(
          front, 0, sizeof(unsigned long long) * t.blocks * t.B * t.W, s)))
    return e;
  void* args[] = {&E, &front, &parents, &t, &lo, &width, &lo0, &width0};
  if (const int e = static_cast<int>(cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(kernel), dim3(ctas), dim3(threads),
          args, smem, s)))
    return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct_carver

// E: (B, H, W) f32 row-major; parents: (B, H, Wp) int8 scratch, Wp = W
// rounded up to a multiple of 4; seams: (B, H) int32 out; front:
// (ceil((H - 1) / K), B, W) 64-bit scratch, one slice a block.  Image b's
// DP runs over the column window [lo_b, lo_b + width_b), read from lo[b]
// and width[b] (int32 arrays on the device), or lo0 and width0 for every
// image where the pointer is null.  C: columns a lane (4 or 8); Wt: owned
// columns a tile (a multiple of 4); K: rows a block, with Hh = K rounded up
// to 4, Hh <= Wt and Wt + 2 * Hh <= 32 * C; warps: warp-tiles a CTA
// (1..8); max_warps: a cap on the warps launched (0: as many as are
// resident).  Launches, on `stream`, the frontier's memset, the forward and
// the finish when H >= 2, else only the finish.  Returns the first
// cudaError_t of a call or launch.
extern "C" int dc_find_seams_tiled(const float* E, int8_t* parents,
                                   int* seams, unsigned long long* front,
                                   int B, int H, int W, const int* lo,
                                   const int* width, int lo0, int width0,
                                   int rightmost, int C, int Wt, int K,
                                   int warps, int max_warps, void* stream) {
  using namespace dct_carver;
  const int Hh = (K + 3) & ~3;
  if ((C != 4 && C != 8) || Wt < 4 || Wt % 4 != 0 || K < 1 || Hh > Wt ||
      Wt + 2 * Hh > 32 * C || warps < 1 || warps > kMaxTileWarps ||
      B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (W + Wt - 1) / Wt;
  if (static_cast<long long>(B) * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the last DP row: row 0 of each plane when H = 1, else the last block's
  // frontier cells (a cell's value is its low 32 bits)
  const float* F = E;
  long long f_stride = static_cast<long long>(H) * W;
  int f_step = 1;
  if (H >= 2) {
    const Tiling t{B, H, W, tiles, Wt, Hh, K, (H - 2) / K + 1, 1};
    // 16-byte energy copies when every row starts 16-byte aligned
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
    const auto go = [&](auto c) {
      constexpr int CC = decltype(c)::value;
      if (vec)
        return rightmost
                   ? launch_forward<CC, true, true>(E, front, parents, t, lo,
                                                    width, lo0, width0, warps,
                                                    max_warps, s)
                   : launch_forward<CC, true, false>(E, front, parents, t, lo,
                                                     width, lo0, width0,
                                                     warps, max_warps, s);
      return rightmost
                 ? launch_forward<CC, false, true>(E, front, parents, t, lo,
                                                   width, lo0, width0, warps,
                                                   max_warps, s)
                 : launch_forward<CC, false, false>(E, front, parents, t, lo,
                                                    width, lo0, width0, warps,
                                                    max_warps, s);
    };
    const int err = C == 4 ? go(std::integral_constant<int, 4>{})
                           : go(std::integral_constant<int, 8>{});
    if (err) return err;
    F = reinterpret_cast<const float*>(
        front + static_cast<size_t>(t.blocks - 1) * B * W);
    f_stride = 2LL * W;
    f_step = 2;
  }
  const auto finish = rightmost ? finish_kernel<true> : finish_kernel<false>;
  finish<<<B, kFinishThreads, 0, s>>>(F, f_stride, f_step, parents, seams, H,
                                      W, lo, width, lo0, width0);
  return static_cast<int>(cudaGetLastError());
}
