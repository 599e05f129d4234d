// Find one vertical seam in each of B images by the masked min-plus DP over
// column tiles: the forward in K-row blocks, then the argmin of the last row
// and the backtrack.
//
// Replaces dct_carver_tpu/pallas/dp_kernel.py's streamed route, which takes
// any width: dp_forward (the pl.pallas_call at :124, kernel
// _make_dp_forward_kernel :70) writing the parents and the last DP row to
// HBM row block by row block, the argmin, and dp_backtrack (:184, kernel
// _backtrack_kernel :148), chosen at :596-607.
//
// What bounds it on an H100: latency, twice over.  Row r depends on row
// r-1, so a tile's rows run one after the other; one CTA a row
// (find_seam.cu) pays a barrier over all its warps every row.  Here a tile's
// DP runs in one warp and a row needs no barrier, only two shuffles, so a
// row costs the cycles that warp takes to send out its instructions.  Then
// a block costs a round trip between warps: a tile's halo columns come from
// its neighbours' last row of the block before, so each block ends with
// stores that the neighbours wait to see through the L2.  K rows a block
// amortise it; the halo of Hh >= K columns a side that keeps a block's
// owned values exact costs compute, which a latency-bound row has to spare.
//
// Geometry.  Lane l of the DP warp owns the C contiguous columns [l*C,
// l*C + C) of an extended row of at most 32*C columns: Wt owned columns and
// Hh = K rounded up to 4 halo columns a side (Hh <= Wt, so the halo reaches
// only the two neighbouring tiles; lanes past Wt + 2*Hh hold +inf).  Each
// row the lane takes its neighbours' edge cells with __shfl_up_sync/
// __shfl_down_sync (+inf beyond lanes 0 and 31) and runs chunk_row
// (dp_rows.cuh), the op order m = e + min(min(left, centre), right) with
// __fadd_rn; a tile whose lanes all lie in the image's column window skips
// the window's test.  A value |dc| columns from the extended row's ends is
// exact for |dc| rows (parallel/spatial.py :15-19's argument), so the owned
// columns are exact for all K rows of a block that starts from exact values
// on the whole extended row.  Parents go out as one packed 32-bit word per
// 4 owned columns a row, into the same (B, H, Wp) int8 scratch as
// find_seam.cu; the parents of halo columns are never stored.
//
// Two schedules of the same rows, chosen by SPLIT
// (kernels/dp_kernel.py::split_forward picks it by the tile count):
//
// One warp a tile (SPLIT false; up to 8 tiles a CTA, one warp each).  The
// warp also stages its energy and writes its parents: each lane copies its
// own columns by cp.async into a per-lane ring of shared memory, kStages - 1
// rows ahead (16 bytes a lane a row at C = 4); a lane reads only what it
// copied, so the ring needs cp.async.wait_group and no barrier.  The rows
// are unrolled kStages at a time, so every ring slot is a constant; each
// row the lane also works out the tie-most parent_byte of its columns and
// stores its owned words (128 B a warp a row at C = 4).  It fills the card
// best when there are many tiles.
//
// Split (SPLIT true): a tile is one CTA of 1 + kHelpers warps, and the
// warp that carries the dependent chain does nothing else.
//   - The DP warp, each row: the two shuffles, one ld.shared.v4 (C / 4 of
//     them) of the energy, fminf(fminf(l, c), r) and __fadd_rn a column,
//     and one st.shared.v4 of the row it starts from into the rows ring;
//     the frontier's loads and stores at the ends of a block, as below.
//   - The helper warps stage the energy of every group of kGroup rows
//     kDepth - 1 groups ahead with cp.async (16-byte copies where rows are
//     16-byte aligned, else 4-byte ones), across the ends of blocks, so a
//     block's first rows are in shared memory before its frontier is; and
//     for each group the DP warp has left, they read its rows back,
//     recompute mn = fminf(fminf(l, c), r) from the same three values and
//     store parent_byte's packed words for the owned columns.  A parent
//     depends only on the row before, so each is bitwise the one-warp
//     schedule's.
//   Two rings of kDepth = 3 slots of one group each: energy (helpers write,
//   DP warp reads) and rows (the reverse).  Group j (numbered over the
//   CTA's whole run of blocks and tiles, the same on both sides) uses slot
//   j % 3 of both.  Named barriers, each with all 32 (1 + kHelpers)
//   threads, two IDs a direction used by group parity:
//     E(j) (IDs 1-2): the helpers arrive once group j's energy has landed
//       (cp.async.wait_group in each thread first); the DP warp syncs on it
//       before group j.
//     R(j) (IDs 3-4): the DP warp arrives after group j, when its rows are
//       in the rows ring and its energy has been read; the helpers sync on
//       it, arrive at E(j + 2) (staged a group earlier), stage group j + 3
//       into slot j % 3 and then write group j's parents.
//   A barrier's arrivals order the arriving threads' earlier shared-memory
//   accesses before the syncing threads' later ones.  No race:
//     - Energy, read after write: group j is read after E(j), which follows
//       every copy of it.  Write after read: group j + 3 is staged into
//       slot j % 3 after R(j), when the DP warp is done with group j; by
//       E(j + 3)'s absence the DP warp is at most in group j + 2.
//     - Rows, read after write: group j is read after R(j).  Write after
//       read: the DP warp writes group j + 3 into slot j % 3 after E(j + 3),
//       to which the helpers arrive only after group j's parents.
//     - The IDs: the helpers arrive at E(j + 2) after R(j), so the DP warp
//       has passed E(j), the last use of that ID; the DP warp arrives at
//       R(j + 2) after E(j + 2), so the helpers have passed R(j).
//   So the DP warp waits on a helper only when the helpers fall two groups
//   behind, and a group costs it one bar.sync and one bar.arrive.
//
// One launch runs every block of every tile.  The grid is cooperative
// (cudaLaunchCooperativeKernel) and at most as large as the occupancy API
// says is resident, so every warp whose cells a warp waits for is running:
// a grid that cannot be resident is a launch error, not a hang.  Under a
// CUDA graph's stream capture (the carve's seam step, ops/carve.py) the
// launch becomes a cooperative kernel node and the frontier's memset a
// memset node; CUDA 12.8 accepts both (chip_smoke.py phase 2 replays such
// graphs and holds their seams against the plain DP).  Where
// there are more tiles (B x ceil(W / Wt)) than resident DP warps, each DP
// warp owns a run of adjacent tiles and does block k of all of them before
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
// A last launch, the finish, takes the tie-most argmin of the last
// block's slice and walks the parents up in blocks of kFinishRows rows
// whose parents it first composes into one jump a column (below; the row
// walk of seam_walk.cuh stays find_seam.cu's).  A call with H >= 2 is
// three launches: the memset of the frontier and the finish's counters,
// the forward and the finish; with H = 1 only the finish.
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
// helper warps a split tile: with one the helpers set the pace, three are
// no faster than two (an NVIDIA H100 80GB HBM3; PERF.md §6)
constexpr int kHelpers = 2;
constexpr int kMaxDevices = 64;   // cards whose occupancy is kept

// A warp-tile's staging ring (one warp a tile): kStages rows of 32 lanes,
// each lane's C columns kPitch floats apart (dp_rows.cuh's
// bank-conflict-free pitch): 8 KB (C = 4) or 24 KB (C = 8) a warp.
template <int C>
struct WarpRing {
  static_assert(C == 4 || C == 8, "a warp-tile has 4 or 8 columns a lane");
  static constexpr int kStages = 16;
  static constexpr int kPitch = Chunk<C>::kPitch;
  static constexpr int kSlot = 32 * kPitch;  // floats a slot
  static constexpr size_t kBytes = sizeof(float) * kStages * kSlot;
};

// The split schedule's two rings, energy then rows: kDepth slots of a group
// of kGroup rows each, a row's 32 chunks kPitch floats apart, as the DP
// warp's lanes hold them: 48 KB (C = 4) or 72 KB (C = 8) a CTA.
template <int C>
struct SplitRing {
  static_assert(C == 4 || C == 8, "a warp-tile has 4 or 8 columns a lane");
  static constexpr int kPitch = Chunk<C>::kPitch;
  static constexpr int kRow = 32 * kPitch;        // floats a row
  static constexpr int kGroup = C == 4 ? 16 : 8;  // rows a group
  static constexpr int kDepth = 3;                // groups a ring
  static constexpr int kSlot = kGroup * kRow;     // floats a group
  static constexpr size_t kBytes = 2 * sizeof(float) * kDepth * kSlot;
  // where extended column c >= 0 sits in a row
  __device__ static constexpr int at(int c) {
    const unsigned u = c;
    return u / C * kPitch + u % C;
  }
};
constexpr int kEnergyBar = 1;  // E(j): named barrier kEnergyBar + j % 2
constexpr int kRowsBar = 3;    // R(j): named barrier kRowsBar + j % 2

// Named barriers in their non-.aligned form: a warp's threads may reach
// them apart (after the helpers' uneven parent loops, or the DP warp's
// frontier wait).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads)
               : "memory");
}

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
  int run;     // tiles a DP warp
  __device__ int rows(int k) const { return min(K, H - 1 - k * K); }
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

// A lane's row 0 of block k of a tile of image b (its first column c0):
// the energy's row 0 at k = 0, then block k - 1's last row, each cell once
// its tag says block k - 1 wrote it; +inf outside `win`.
template <int C>
__device__ __forceinline__ void block_row0(float (&m)[C], const float* E_all,
                                           const unsigned long long* front,
                                           const Tiling& t, int k, int b,
                                           int c0, const Window& win) {
  const float inf = INFINITY;
  if (k == 0) {
    const float* f = E_all + static_cast<long long>(b) * t.H * t.W + c0;
#pragma unroll
    for (int i = 0; i < C; ++i) m[i] = win.has(i) ? __ldcg(f + i) : inf;
    return;
  }
  const unsigned long long* f =
      front + (k - 1) * static_cast<size_t>(t.B) * t.W +
      static_cast<long long>(b) * t.W + c0;
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

// The owned part of block k's last row (the lane's columns j0.. of a tile
// whose extended row starts at column col0), tagged k + 1: the next block's
// row 0, or the finish's last row.
template <int C>
__device__ __forceinline__ void store_row(unsigned long long* front,
                                          const float (&m)[C], const Tiling& t,
                                          int k, int b, int col0, int j0) {
  unsigned long long* fn = front + k * static_cast<size_t>(t.B) * t.W +
                           static_cast<long long>(b) * t.W + col0 + j0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = j0 + i;
    if (c >= t.Hh && c < t.Hh + t.Wt && col0 + c < t.W)
      store_cell(fn + i, m[i], k + 1);
  }
}

// The one-warp schedule: every block of every tile of warp (blockIdx.x *
// warps a CTA + warp in the CTA)'s run [g_lo, g_hi) of the B * tiles tiles.
// Rows are staged D - 1 ahead within a segment (block k of tile g); a
// segment's first D - 1 rows are staged as the segment before it ends,
// after its frontier cells are out, so that they land while the next block
// waits for its neighbours' cells.  Every row commits one cp.async group
// (empty past the segment's end), and a segment's first D - 1 rows are D -
// 1 groups: row n of a segment is then its n-th group, in ring slot (n - 1)
// % D, a constant once the rows are unrolled D at a time.
template <int C, bool VEC, bool RIGHTMOST>
__device__ __forceinline__ void warp_rows(
    const float* __restrict__ E_all, unsigned long long* front,
    int8_t* __restrict__ parents_all, const Tiling& t,
    const int* __restrict__ lo_arr, const int* __restrict__ width_arr,
    int lo0, int width0, unsigned char* smem) {
  using Ring = WarpRing<C>;
  constexpr int D = Ring::kStages;
  constexpr int SL = Ring::kSlot;
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
  prologue(seg, t.rows(0));
  for (int k = 0; k < t.blocks; ++k) {
    const int r0 = k * t.K;
    const int N = t.rows(k);
    for (int g = g_lo; g < g_hi; ++g) {
      const int b = g / t.tiles;
      const int col0 = seg.c0 - j0;
      const int lo = lo_arr ? lo_arr[b] : lo0;
      const int hi = min(lo + (width_arr ? width_arr[b] : width0), W);
      const Window win(lo - col0, min(hi - col0, We), j0, C);
      float m[C];
      block_row0<C>(m, E_all, front, t, k, b, seg.c0, win);
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
      store_row<C>(front, m, t, k, b, col0, j0);
      // stage the next segment's first rows
      const bool last = g + 1 == g_hi;
      const int kn = last ? k + 1 : k;
      if (kn < t.blocks) {
        seg = Segment(E_all, t, kn, last ? g_lo : g + 1, j0);
        prologue(seg, t.rows(kn));
      }
    }
  }
  cp_async_wait<0>();
}

// The split schedule's DP warp (warp 0 of CTA blockIdx.x, whose run is
// tiles [g_lo, g_hi)): rows 1 .. N of each segment, a group of G rows
// between E(j) and R(j); the energy of group j from slot j % 3 of the
// energy ring, and the row each step starts from into slot j % 3 of the
// rows ring.
template <int C, bool RIGHTMOST>
__device__ __forceinline__ void split_dp(
    const float* __restrict__ E_all, unsigned long long* front,
    const Tiling& t, const int* __restrict__ lo_arr,
    const int* __restrict__ width_arr, int lo0, int width0, int g_lo,
    int g_hi, const float* ering, float* rring) {
  using Ring = SplitRing<C>;
  constexpr int G = Ring::kGroup;
  constexpr int kThreads = 32 * (1 + kHelpers);
  const unsigned all = 0xffffffffu;
  const float inf = INFINITY;
  const int lane = threadIdx.x;
  const int We = t.Wt + 2 * t.Hh;
  const int j0 = lane * C;
  const float* const e_lane = ering + lane * Ring::kPitch;
  float* const r_lane = rring + lane * Ring::kPitch;
  int j = 0;  // the run's group
  for (int k = 0; k < t.blocks; ++k) {
    const int N = t.rows(k);
    for (int g = g_lo; g < g_hi; ++g) {
      const int b = g / t.tiles;
      const int col0 = (g - b * t.tiles) * t.Wt - t.Hh;
      const int lo = lo_arr ? lo_arr[b] : lo0;
      const int hi = min(lo + (width_arr ? width_arr[b] : width0), t.W);
      const Window win(lo - col0, min(hi - col0, We), j0, C);
      float m[C];
      block_row0<C>(m, E_all, front, t, k, b, col0 + j0, win);
      const auto rows = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        for (int n0 = 0; n0 < N; n0 += G, ++j) {
          const int slot = j % Ring::kDepth * Ring::kSlot;
          bar_sync(kEnergyBar + j % 2, kThreads);  // the group has landed
          alignas(16) float e[G][C];  // rows past N read stale slots: unused
#pragma unroll
          for (int s = 0; s < G; ++s)
#pragma unroll
            for (int q = 0; q < C / 4; ++q)
              *reinterpret_cast<float4*>(&e[s][4 * q]) =
                  *reinterpret_cast<const float4*>(e_lane + slot +
                                                   s * Ring::kRow + 4 * q);
#pragma unroll
          for (int s = 0; s < G; ++s) {
            if (n0 + s >= N) break;
            float left = __shfl_up_sync(all, m[C - 1], 1);
            float right = __shfl_down_sync(all, m[0], 1);
            if (lane == 0) left = inf;
            if (lane == 31) right = inf;
            float* out = r_lane + slot + s * Ring::kRow;
#pragma unroll
            for (int q = 0; q < C / 4; ++q)
              *reinterpret_cast<float4*>(out + 4 * q) = make_float4(
                  m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
            float4 unused[C / 4];
            chunk_row<C, false, RIGHTMOST, MASKED>(m, e[s], win, left, right,
                                                   unused);
          }
          bar_arrive(kRowsBar + j % 2, kThreads);  // rows out, energy read
        }
      };
      if (__all_sync(all, win.a == 0 && win.b == C))
        rows(std::false_type{});
      else
        rows(std::true_type{});
      store_row<C>(front, m, t, k, b, col0, j0);
    }
  }
}

// The split schedule's helper warps (warps 1 .. kHelpers of the CTA): the
// energy of group j + 2 announced and group j + 3 staged after R(j), then
// group j's parents.  Thread h of the helpers takes the 4-column units h,
// h + 32 kHelpers, ... of a group, row by row.
template <int C, bool VEC, bool RIGHTMOST>
__device__ __forceinline__ void split_helpers(
    const float* __restrict__ E_all, int8_t* __restrict__ parents_all,
    const Tiling& t, int g_lo, int g_hi, float* ering, const float* rring) {
  using Ring = SplitRing<C>;
  constexpr int G = Ring::kGroup;
  constexpr int D = Ring::kDepth;
  static_assert(D == 3, "E(j + 2) is announced and j + 3 staged after R(j)");
  constexpr int HT = 32 * kHelpers;
  constexpr int kThreads = HT + 32;
  constexpr int U = 8 * C;  // 4-column units of an extended row
  const int h = threadIdx.x - 32;
  const int We = t.Wt + 2 * t.Hh;
  const int W = t.W;
  const int Wp = parent_pitch(W);
  int J = 0;  // the run's groups
  for (int k = 0; k < t.blocks; ++k) J += (t.rows(k) + G - 1) / G;
  J *= g_hi - g_lo;

  // the next group to stage: rows sn0 + 1 .. of block sk of tile sg
  int sk = 0, sg = g_lo, sn0 = 0;
  const auto stage_next = [&](int slot) {
    const int N = t.rows(sk);
    const int n = min(G, N - sn0);
    const int b = sg / t.tiles;
    const int col0 = (sg - b * t.tiles) * t.Wt - t.Hh;
    const float* src =
        E_all + (static_cast<long long>(b) * t.H + sk * t.K + sn0 + 1) * W +
        col0;
    float* dst = ering + slot * Ring::kSlot;
    if constexpr (VEC) {  // 16 bytes a copy
#pragma unroll
      for (int i = 0; i < (G * U + HT - 1) / HT; ++i) {
        const unsigned e = h + i * HT;
        const int s = e / U, c = 4 * (e % U);
        if (s < n && c < We)
          stage<4, true>(dst + s * Ring::kRow + Ring::at(c),
                         src + static_cast<long long>(s) * W + c, col0 + c,
                         W, true);
      }
    } else {  // 4 bytes a copy, a warp's on 32 adjacent columns
#pragma unroll 4
      for (int i = 0; i < (G * 4 * U + HT - 1) / HT; ++i) {
        const unsigned e = h + i * HT;
        const int s = e / (4 * U), c = e % (4 * U);
        if (s < n && c < We && col0 + c >= 0 && col0 + c < W)
          cp_async4(dst + s * Ring::kRow + Ring::at(c),
                    src + static_cast<long long>(s) * W + c);
      }
    }
    sn0 += G;
    if (sn0 >= N) {
      sn0 = 0;
      if (++sg == g_hi) {
        sg = g_lo;
        ++sk;
      }
    }
  };

  // each thread's parent words: (row s, word q) from (s0, q0), on by
  // (ds, dq) with q < nq = Wt / 4
  const int nq = t.Wt / 4;
  const int s0 = h / nq, q0 = h % nq, ds = HT / nq, dq = HT % nq;
  const auto parents = [&](int k, int g, int n0, int n, int slot) {
    const int b = g / t.tiles;
    const int col0 = (g - b * t.tiles) * t.Wt - t.Hh;
    int8_t* P = parents_all +
                (static_cast<long long>(b) * t.H + k * t.K + n0 + 1) * Wp +
                col0;
    const float* rows = rring + slot * Ring::kSlot;
    for (int s = s0, q = q0; s < n;) {
      const int c = t.Hh + 4 * q;
      if (col0 + c < W) {
        const float* pv = rows + s * Ring::kRow;
        const float4 x =
            *reinterpret_cast<const float4*>(pv + Ring::at(c));
        const float v[6] = {pv[Ring::at(c - 1)], x.x, x.y, x.z, x.w,
                            pv[Ring::at(c + 4)]};
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mn = fminf(fminf(v[i], v[i + 1]), v[i + 2]);
          word |= parent_byte<RIGHTMOST>(v[i], v[i + 1], v[i + 2], mn)
                  << (8 * i);
        }
        *reinterpret_cast<uint32_t*>(P + static_cast<long long>(s) * Wp + c) =
            word;
      }
      s += ds;
      q += dq;
      if (q >= nq) {
        q -= nq;
        ++s;
      }
    }
  };

  // groups 0 .. 2 into slots 0 .. 2; E(0) and E(1) once 0 and 1 landed
  for (int i = 0; i < D; ++i) {
    if (i < J) stage_next(i);
    cp_async_commit();
  }
  cp_async_wait<1>();
  if (J > 0) bar_arrive(kEnergyBar, kThreads);
  if (J > 1) bar_arrive(kEnergyBar + 1, kThreads);
  int j = 0;
  for (int k = 0; k < t.blocks; ++k) {
    const int N = t.rows(k);
    for (int g = g_lo; g < g_hi; ++g) {
      for (int n0 = 0; n0 < N; n0 += G, ++j) {
        const int slot = j % D;
        bar_sync(kRowsBar + j % 2, kThreads);  // the DP warp is past group j
        if (j + 2 < J) {
          cp_async_wait<0>();  // group j + 2, staged a group ago
          bar_arrive(kEnergyBar + j % 2, kThreads);
        }
        if (j + 3 < J) {
          stage_next(slot);
          cp_async_commit();
        }
        parents(k, g, n0, min(G, N - n0), slot);
      }
    }
  }
  cp_async_wait<0>();
}

// The forward, in the schedule SPLIT names (see the header).
template <int C, bool VEC, bool RIGHTMOST, bool SPLIT>
__global__ void __launch_bounds__(32 * kMaxTileWarps)
tile_rows_kernel(const float* __restrict__ E_all, unsigned long long* front,
                 int8_t* __restrict__ parents_all, Tiling t,
                 const int* __restrict__ lo_arr,
                 const int* __restrict__ width_arr, int lo0, int width0) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (!SPLIT) {
    warp_rows<C, VEC, RIGHTMOST>(E_all, front, parents_all, t, lo_arr,
                                 width_arr, lo0, width0, smem);
  } else {
    const int g_lo = blockIdx.x * t.run;
    if (g_lo >= t.B * t.tiles) return;  // the whole CTA: no tile
    const int g_hi = min(g_lo + t.run, t.B * t.tiles);
    float* ering = reinterpret_cast<float*>(smem);
    float* rring = ering + SplitRing<C>::kDepth * SplitRing<C>::kSlot;
    if (threadIdx.x < 32)
      split_dp<C, RIGHTMOST>(E_all, front, t, lo_arr, width_arr, lo0, width0,
                             g_lo, g_hi, ering, rring);
    else
      split_helpers<C, VEC, RIGHTMOST>(E_all, parents_all, t, g_lo, g_hi,
                                       ering, rring);
  }
}

// The finish: the tie-most argmin of each image's last DP row and the walk
// up its parents, in blocks of R = kFinishRows parent rows (block k holds
// rows kR + 1 .. min((k + 1)R, H - 1)).  A step is c = clamp(c + P[r][c],
// 0, W - 1), so a block's R steps compose into one map a column: its jump,
// the column at the block's top row less the column at its bottom row,
// |jump| <= R, one int8.  One launch, three phases:
//   1. Items, taken by the CTAs in turn (each its first by its index, then
//      by an atomic ticket, so that a CTA held up by phases 2-3 takes
//      fewer): each image's argmin, and its compose items (block, chunk of
//      `cols` columns, one or two a thread): the block's parents around
//      the chunk (R columns a side) are staged in shared memory in one
//      round trip, a row a warp, then each thread follows its columns'
//      parents up and stores their jumps.
//   2. Walk the blocks: the last CTA of an image to finish an item (an
//      atomic count an image, after a __threadfence) walks the image's
//      jumps from the argmin up, in rounds of as many blocks as a window
//      of the jump table that the round cannot leave fits in shared
//      memory (a block moves the seam at most R columns), and keeps each
//      block's two end columns.
//   3. Fill: a block's seam reads its n rows of parents within n + 1
//      columns (it starts at cb and ends at ct, one column a row at most),
//      so that CTA stages those windows for as many blocks as fit in one
//      round trip, then one thread a block walks its rows and writes the
//      seam.
// So a seam takes ~H / R + 2R dependent steps instead of H - 1.  A plane
// of one block (H - 1 <= R), and a stack whose B * W passes
// kComposeColumns, have no items but the argmin: a CTA an image walks the
// rows block after block, each from a window of R - 1 columns a side of
// its bottom column, as the row walk of seam_walk.cuh did; composing
// reads every parent, and from about that many columns it costs more than
// the images' row walks side by side.  The grid is at most what is
// resident; no CTA waits for another, so any grid is safe.
constexpr int kFinishRows = 64;                  // R: a multiple of K
constexpr int kFinishWarps = kFinishThreads / 32;
constexpr size_t kFinishSmem = 220 * 1024;       // dynamic shared memory
constexpr int kJumpRows = 40;                    // blocks a walk round, least
constexpr int kWalkBlocks = 256;                 // block ends a walker keeps
// the most columns B * W that the finish composes: on an H100, composing
// took a fifth less time than seam_walk.cuh's row walk at 32 768 and
// 40 000 (32 x 1024, 1 x 40 000) and 7-11 % more at 61 440 and 80 000
// (32 x 1920, 2 x 40 000)
constexpr long long kComposeColumns = 48 * 1024;
static_assert(kFinishRows % 32 == 0 && kFinishRows <= 127,
              "a multiple of the forward's K = 32 whose jumps fit an int8");
// G rows of the jump window, 2GR + 1 columns each from a 16-byte boundary
static_assert(kJumpRows * (2 * kJumpRows * kFinishRows + 16) <= kFinishSmem,
              "a jump window");
// a staged compose row: columns [c0 - R, c0 + 2 * kFinishThreads + R)
// from a 16-byte boundary
static_assert(kFinishRows * (2 * kFinishThreads + 2 * kFinishRows + 32) <=
                  kFinishSmem, "a compose item");

// The finish's blocks for H rows: ceil((H - 1) / R), 0 for one row.
__host__ __device__ inline int finish_blocks(int H) {
  return H > 1 ? (H - 2) / kFinishRows + 1 : 0;
}

// The row pitch of the jump table: W rounded up to 16 bytes.
__host__ __device__ inline int jump_pitch(int W) { return (W + 15) & ~15; }

// One finish launch.  Its scratch lies in the frontier's allocation: after
// the frontier's slices one 64-bit cell an image (its count of items done
// and its argmin) and one for the tickets, cleared by the frontier's
// memset; then, from a 16-byte boundary, the jumps (B, blocks,
// jump_pitch(W)) int8.  All are used only when the blocks are composed.
struct Finish {
  // the last DP row: column c of image b at F[b * f_stride + c * f_step]
  const float* F;
  long long f_stride;
  int f_step;
  const int8_t* parents;
  int* seams;
  unsigned* cell;  // image b: cell[2b] items done, cell[2b + 1] its argmin;
                   // cell[2B]: the tickets taken
  int8_t* jumps;
  int B, H, W;
  int blocks;     // finish_blocks(H)
  bool composed;  // blocks > 1 and B * W <= kComposeColumns
  int cols;       // columns a compose item: 512, 1024 or 2048
  int chunks;  // compose items a block: ceil(W / cols)
  const int* lo_arr;
  const int* width_arr;
  int lo0, width0;
};

// Copies of U bytes a row of a fill window whose reads span `span` + 1
// columns from any start: the span, the start's offset in its U bytes, and
// the column itself.
__host__ __device__ constexpr int fill_units(int U, int span) {
  return (span + 2 * U - 1) / U;
}

// Fill windows a turn: R rows of fill_units(U, R) copies each.
template <int U>
__host__ __device__ constexpr int fill_slots() {
  return static_cast<int>(kFinishSmem /
                          (kFinishRows * U * fill_units(U, kFinishRows)));
}

// cp.async of U bytes (4 or 16) from global to shared memory.
template <int U>
__device__ __forceinline__ void copy(void* dst, const void* src) {
  if (U == 16)
    cp_async16(static_cast<float*>(dst), static_cast<const float*>(src));
  else
    cp_async4(static_cast<float*>(dst), static_cast<const float*>(src));
}

// The tie-most argmin of image b's last DP row through its window, to
// every thread.
template <bool RIGHTMOST>
__device__ int last_argmin(const Finish& f, int b) {
  const float* F = f.F + b * f.f_stride;
  const int lo = f.lo_arr ? f.lo_arr[b] : f.lo0;
  const int hi = min(lo + (f.width_arr ? f.width_arr[b] : f.width0), f.W);
  __shared__ float s_v[kFinishWarps];
  __shared__ int s_j[kFinishWarps + 1];
  const int t = threadIdx.x;
  float bv = INFINITY;
  int bj = -1;
  for (int c = t; c < f.W; c += blockDim.x) {
    const float v = c >= lo && c < hi ? F[c * f.f_step] : INFINITY;
    if (better<RIGHTMOST>(v, c, bv, bj)) {
      bv = v;
      bj = c;
    }
  }
  // each warp's best by shuffles, then warp 0's over the warps'
  const auto warp_best = [&]() {
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (oj >= 0 && better<RIGHTMOST>(ov, oj, bv, bj)) {
        bv = ov;
        bj = oj;
      }
    }
  };
  warp_best();
  if (t % 32 == 0) {
    s_v[t / 32] = bv;
    s_j[t / 32] = bj;
  }
  __syncthreads();
  if (t < 32) {
    bv = s_v[t];
    bj = s_j[t];
    warp_best();
    if (t == 0) s_j[kFinishWarps] = bj;
  }
  __syncthreads();
  return s_j[kFinishWarps];
}

// Phase 1 for block k, columns [ch * f.cols, ...) of image b, with copies
// of U bytes (16 where the parents' rows start 16-byte aligned).
template <int U>
__device__ void compose(const Finish& f, int b, int k, int ch,
                        unsigned char* smem) {
  constexpr int R = kFinishRows;
  const int t = threadIdx.x;
  const int W = f.W;
  const int Wp = parent_pitch(W);
  const int bot = min((k + 1) * R, f.H - 1);
  const int n = bot - k * R;
  const int c0 = ch * f.cols;
  const int c1 = min(c0 + f.cols, W);
  const int ws = max(c0 - n, 0) & ~(U - 1);
  const int pitch = (min(c1 + n, W) - ws + U - 1) / U * U;
  // staged row r is parent row bot - r, a row a warp at a time
  const int8_t* P =
      f.parents + (static_cast<size_t>(b) * f.H + bot) * Wp + ws;
  for (int r = t / 32; r < n; r += kFinishWarps) {
    const int8_t* src = P - static_cast<size_t>(r) * Wp;
    for (int x = t % 32 * U; x < pitch; x += 32 * U)
      copy<U>(smem + r * pitch + x, src + x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // each thread's columns c0 + t and c0 + t + kFinishThreads, each as the
  // column less its start
  const int ca = c0 + t, cb = ca + kFinishThreads;
  const int8_t* row = reinterpret_cast<const int8_t*>(smem);
  int8_t* J = f.jumps + (static_cast<size_t>(b) * f.blocks + k) *
                            jump_pitch(W);
  if (cb < c1) {
    int da = 0, db = 0;
    for (int r = 0; r < n; ++r, row += pitch) {
      da = min(max(da + row[ca - ws + da], -ca), W - 1 - ca);
      db = min(max(db + row[cb - ws + db], -cb), W - 1 - cb);
    }
    J[ca] = static_cast<int8_t>(da);
    J[cb] = static_cast<int8_t>(db);
  } else if (ca < c1) {
    int da = 0;
    for (int r = 0; r < n; ++r, row += pitch)
      da = min(max(da + row[ca - ws + da], -ca), W - 1 - ca);
    J[ca] = static_cast<int8_t>(da);
  }
}

// Phase 3 for blocks i0 .. i0 + m - 1 of a turn whose first block is k1
// (block k1 - i, its ends s_cb[i] and s_ct[i]): the parents each one's
// rows can reach, in rows of Q copies of U bytes a window, staged all at
// once, then thread j walks block i0 + j up from its bottom column.  WIDE:
// one block whose top column is unknown, so its window is R - 1 columns a
// side of the bottom one; the walk leaves the top column in s_ct[i0].
template <int U, bool WIDE>
__device__ void fill(const Finish& f, int b, int k1, int i0, int m,
                     const int* s_cb, int* s_ct, unsigned char* smem) {
  constexpr int R = kFinishRows;
  // a block's rows read columns within [a, a + n] (a + 2n - 2 WIDE)
  constexpr int Q = fill_units(U, WIDE ? 2 * R - 2 : R);
  constexpr int kPitch = Q * U;
  constexpr int kSlot = R * kPitch;
  static_assert(kSlot <= kFinishSmem, "a fill window");
  __shared__ int s_lo[64];
  static_assert(fill_slots<U>() <= 64, "a window start a slot");
  const int t = threadIdx.x;
  const int H = f.H, W = f.W;
  const int Wp = parent_pitch(W);
  const int8_t* P = f.parents + static_cast<size_t>(b) * H * Wp;
  int* seam = f.seams + static_cast<size_t>(b) * H;
  int bot = 0, n = 0, cb = 0;
  bool inner = true;  // no step can leave [0, W): no clamp
  if (t < m) {
    const int k = k1 - i0 - t;
    bot = min((k + 1) * R, H - 1);
    n = bot - k * R;
    cb = s_cb[i0 + t];
    const int x = cb + s_ct[i0 + t];
    const int a = WIDE ? max(cb - n + 1, 0) : max(x - n + 1, 0) >> 1;
    // Q copies from lo hold [a, a + n] (a + 2n - 2) and stay in the row
    s_lo[t] = min(a & ~(U - 1), max(Wp - kPitch, 0));
    inner = a >= 1 && a + (WIDE ? 2 * n - 2 : n) <= W - 2;
  }
  inner = __all_sync(0xffffffffu, inner);  // the warp's walks in step
  __syncthreads();
  // only the U bytes that row r of block j can reach: within r columns of
  // its bottom column, and within n - r of its top one
  for (int e = t; e < m * R * Q; e += blockDim.x) {
    const int j = e / (R * Q);
    const int r = (e - j * R * Q) / Q;
    const int x = s_lo[j] + (e - j * R * Q - r * Q) * U;
    const int kj = k1 - i0 - j;
    const int bj = min((kj + 1) * R, H - 1);
    const int nj = bj - kj * R;
    const int cj = s_cb[i0 + j];
    int a = cj - r, z = cj + r;
    if (!WIDE) {
      a = max(a, s_ct[i0 + j] - nj + r);
      z = min(z, s_ct[i0 + j] + nj - r);
    }
    if (r < nj && x + U <= Wp && x + U > a && x <= z)
      copy<U>(smem + j * kSlot + r * kPitch + x - s_lo[j],
              P + static_cast<size_t>(bj - r) * Wp + x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (t < m) {
    const int8_t* p =
        reinterpret_cast<const int8_t*>(smem) + t * kSlot + cb - s_lo[t];
    int d = 0;  // the column less cb
    if (inner) {
      for (int r = 1; r <= n; ++r, p += kPitch) {
        d += p[d];
        seam[bot - r] = cb + d;
      }
    } else {
      for (int r = 1; r <= n; ++r, p += kPitch) {
        d = min(max(d + p[d], -cb), W - 1 - cb);
        seam[bot - r] = cb + d;
      }
    }
    if (WIDE) s_ct[i0 + t] = cb + d;
  }
  __syncthreads();  // the windows are free again
}

// Phases 2 and 3 for image b from its argmin c; all threads of the CTA
// call it.
template <int U>
__device__ void walk_blocks(const Finish& f, int b, int c,
                            unsigned char* smem) {
  constexpr int R = kFinishRows;
  constexpr int kSlots = fill_slots<U>();
  __shared__ int s_cb[kWalkBlocks], s_ct[kWalkBlocks];  // a block's ends
  __shared__ int s_c;
  const int t = threadIdx.x;
  const int W = f.W;
  const int Jp = jump_pitch(W);
  const int8_t* J = f.jumps + static_cast<size_t>(b) * f.blocks * Jp;
  if (t == 0) f.seams[static_cast<size_t>(b) * f.H + f.H - 1] = c;
  if (!f.composed) {  // the row walk, block after block
    for (int k = f.blocks - 1; k >= 0; --k) {
      if (t == 0) s_cb[0] = c;
      __syncthreads();
      fill<U, true>(f, b, k, 0, 1, s_cb, s_ct, smem);
      c = s_ct[0];
    }
    return;
  }
  // rows of a round: kJumpRows, or as many rows as wide as the plane (and
  // 16-byte boundaries) as fit
  const int rows = max(kJumpRows, static_cast<int>(kFinishSmem /
                                                   ((W + 46) & ~15)));
  // blocks k1 .. k0 a turn, from the bottom
  for (int k1 = f.blocks - 1; k1 >= 0; k1 -= kWalkBlocks) {
    const int k0 = max(k1 - kWalkBlocks + 1, 0);
    // the jumps of blocks kh .. kh - G + 1 at columns [ws, ws + 16q),
    // which hold [c - GR, c + GR] clamped to [0, W)
    for (int kh = k1; kh >= k0; kh -= rows) {
      const int G = min(rows, kh - k0 + 1);
      const int ww = min(2 * G * R + 1, W);
      const int w0 = min(max(c - G * R, 0), W - ww);
      const int ws = w0 & ~15;
      const int q = (w0 + ww - ws + 15) / 16;
      // row r is read r jumps from c: within rR columns of it
      for (int e = t; e < G * q; e += blockDim.x) {
        const int r = e / q;
        const int x = ws + 16 * (e - r * q);
        if (x + 16 > c - r * R && x <= c + r * R)
          copy<16>(smem + 16 * e, J + static_cast<size_t>(kh - r) * Jp + x);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (t == 0) {
        for (int i = 0; i < G; ++i) {
          s_cb[k1 - kh + i] = c;
          c += static_cast<int8_t>(smem[16 * q * i + c - ws]);
          s_ct[k1 - kh + i] = c;
        }
        s_c = c;
      }
      __syncthreads();
      c = s_c;
    }
    for (int i0 = 0; i0 <= k1 - k0; i0 += kSlots)
      fill<U, false>(f, b, k1, i0, min(kSlots, k1 - k0 + 1 - i0), s_cb, s_ct,
                     smem);
  }
}

// The kernel, with copies of U bytes (16 where the parents' rows start
// 16-byte aligned).
template <bool RIGHTMOST, int U>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const Finish f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_last;
  __shared__ unsigned s_next;
  const int t = threadIdx.x;
  if (!f.composed) {  // no items but the argmin: a CTA an image
    for (int b = blockIdx.x; b < f.B; b += gridDim.x)
      walk_blocks<U>(f, b, last_argmin<RIGHTMOST>(f, b), smem);
    return;
  }
  // an image's items: its argmin, then blocks x chunks compose items
  const long long items = 1 + static_cast<long long>(f.blocks) * f.chunks;
  unsigned* tickets = f.cell + 2 * f.B;
  for (long long it = blockIdx.x; it < f.B * items;) {
    if (t == 0) s_next = atomicAdd(tickets, 1u);  // lands while it works
    const int b = static_cast<int>(it / items);
    const int i = static_cast<int>(it - b * items) - 1;
    if (i < 0) {
      const int j = last_argmin<RIGHTMOST>(f, b);
      if (t == 0) f.cell[2 * b + 1] = j;
    } else {
      compose<U>(f, b, i / f.chunks, i % f.chunks, smem);
    }
    __syncthreads();
    if (t == 0) {
      __threadfence();  // the CTA's jumps or argmin, before the count
      const bool last = atomicAdd(f.cell + 2 * b, 1u) == items - 1;
      if (last) __threadfence();  // every item's, before they are read
      s_last = last;
    }
    __syncthreads();
    it = gridDim.x + static_cast<long long>(s_next);
    if (s_last) walk_blocks<U>(f, b, __ldcg(f.cell + 2 * b + 1), smem);
    __syncthreads();  // every thread has read s_next and s_last
  }
}

template <bool RIGHTMOST, int U>
int launch_finish(Finish f, cudaStream_t s) {
  const auto kernel = finish_kernel<RIGHTMOST, U>;
  // CTAs resident on the card, asked of the runtime once a device and kept
  static int resident_by[kMaxDevices] = {};
  int dev = 0;
  if (const int e = static_cast<int>(cudaGetDevice(&dev))) return e;
  int resident = dev < kMaxDevices ? resident_by[dev] : 0;
  if (resident == 0) {
    if (const int e = allow_smem(kernel, kFinishSmem)) return e;
    int sms = 0, per_sm = 0;
    if (const int e = static_cast<int>(cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev)))
      return e;
    if (const int e = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kFinishThreads, kFinishSmem)))
      return e;
    resident = per_sm * sms;
    if (dev < kMaxDevices) resident_by[dev] = resident;
  }
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the narrowest compose items whose count fits one wave: a chain of R
  // steps a column, and a CTA's items share its shared memory's bandwidth
  long long items = f.B;
  for (int cols = kFinishThreads / 2; cols <= 2 * kFinishThreads;
       cols *= 2) {
    f.cols = cols;
    f.chunks = (f.W + cols - 1) / cols;
    if (f.composed)
      items = f.B * (1 + static_cast<long long>(f.blocks) * f.chunks);
    if (items <= resident) break;
  }
  kernel<<<static_cast<int>(std::min<long long>(items, resident)),
           kFinishThreads, kFinishSmem, s>>>(f);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool VEC, bool RIGHTMOST, bool SPLIT>
int launch_forward(const float* E, unsigned long long* front,
                   int8_t* parents, Tiling t, const int* lo, const int* width,
                   int lo0, int width0, int warps, int max_warps,
                   cudaStream_t s) {
  const auto kernel = tile_rows_kernel<C, VEC, RIGHTMOST, SPLIT>;
  // the tiles' DP warps a CTA: `warps` one-warp tiles, or one split tile
  const int runners = SPLIT ? 1 : warps;
  const int threads = 32 * (SPLIT ? 1 + kHelpers : warps);
  const size_t smem =
      SPLIT ? SplitRing<C>::kBytes : warps * WarpRing<C>::kBytes;
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
    resident = static_cast<long long>(per_sm) * sms * runners;
    if (dev < kMaxDevices) resident_by[dev][warps] = resident;
  }
  if (max_warps > 0) resident = std::min<long long>(resident, max_warps);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long G = static_cast<long long>(t.B) * t.tiles;
  t.run = static_cast<int>((G + resident - 1) / resident);
  const long long used = (G + t.run - 1) / t.run;
  const int ctas = static_cast<int>((used + runners - 1) / runners);
  void* args[] = {&E, &front, &parents, &t, &lo, &width, &lo0, &width0};
  if (const int e = static_cast<int>(cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(kernel), dim3(ctas), dim3(threads),
          args, smem, s)))
    return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct_carver

// E: (B, H, W) f32 row-major; parents: (B, H, Wp) int8 scratch, Wp = W
// rounded up to a multiple of 4; seams: (B, H) int32 out; front: 64-bit
// scratch of tiled_scratch_cells (kernels/dp_kernel.py) cells: the
// frontier's ceil((H - 1) / K) slices of (B, W) cells, one a block, then the
// finish's B counters and jumps (struct Finish).  Image b's DP runs over
// the column window [lo_b, lo_b + width_b), read from lo[b] and width[b]
// (int32 arrays on the device), or lo0 and width0 for every image where
// the pointer is null.  C: columns a lane (4 or 8); Wt: owned columns a
// tile (a multiple of 4); K: rows a block, with Hh = K rounded up to 4,
// Hh <= Wt and Wt + 2 * Hh <= 32 * C; split: the forward's schedule (0:
// one warp a tile, 1: a CTA a tile, its DP warp and kHelpers helper
// warps); warps: warp-tiles a CTA (1..8; 1 when split); max_warps: a cap
// on the tiles' DP warps
// launched (0: as many as are resident).  Launches, on `stream`, the
// memset of the frontier and the counters, the forward and the finish when
// H >= 2, else only the finish.  Returns the first cudaError_t of a call
// or launch.
extern "C" int dc_find_seams_tiled(const float* E, int8_t* parents,
                                   int* seams, unsigned long long* front,
                                   int B, int H, int W, const int* lo,
                                   const int* width, int lo0, int width0,
                                   int rightmost, int C, int Wt, int K,
                                   int warps, int split, int max_warps,
                                   void* stream) {
  using namespace dct_carver;
  const int Hh = (K + 3) & ~3;
  if ((C != 4 && C != 8) || Wt < 4 || Wt % 4 != 0 || K < 1 || Hh > Wt ||
      Wt + 2 * Hh > 32 * C || warps < 1 || warps > kMaxTileWarps ||
      (split && warps != 1) ||
      B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (W + Wt - 1) / Wt;
  if (static_cast<long long>(B) * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the last DP row: row 0 of each plane when H = 1, else the last block's
  // frontier cells (a cell's value is its low 32 bits)
  Finish f{E, static_cast<long long>(H) * W, 1, parents, seams, nullptr,
           nullptr, B, H, W, finish_blocks(H),
           finish_blocks(H) > 1 &&
               static_cast<long long>(B) * W <= kComposeColumns,
           0, 0, lo, width, lo0, width0};
  if (H >= 2) {
    const Tiling t{B, H, W, tiles, Wt, Hh, K, (H - 2) / K + 1, 1};
    const size_t cells = static_cast<size_t>(t.blocks) * B * W;
    // tag 0 marks a frontier cell no block has written; the finish's cells
    // start at no item done and no ticket taken
    if (const int e = static_cast<int>(cudaMemsetAsync(
            front, 0, sizeof(unsigned long long) * (cells + B + 1), s)))
      return e;
    // 16-byte energy copies when every row starts 16-byte aligned
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
    // each runtime choice as a compile-time constant
    const auto go = [&](auto c, auto v, auto r, auto h) {
      return launch_forward<decltype(c)::value, decltype(v)::value,
                            decltype(r)::value, decltype(h)::value>(
          E, front, parents, t, lo, width, lo0, width0, warps, max_warps, s);
    };
    const auto by_split = [&](auto c, auto v, auto r) {
      return split ? go(c, v, r, std::true_type{})
                   : go(c, v, r, std::false_type{});
    };
    const auto by_tie = [&](auto c, auto v) {
      return rightmost ? by_split(c, v, std::true_type{})
                       : by_split(c, v, std::false_type{});
    };
    const auto by_vec = [&](auto c) {
      return vec ? by_tie(c, std::true_type{}) : by_tie(c, std::false_type{});
    };
    const int err = C == 4 ? by_vec(std::integral_constant<int, 4>{})
                           : by_vec(std::integral_constant<int, 8>{});
    if (err) return err;
    f.F = reinterpret_cast<const float*>(
        front + static_cast<size_t>(t.blocks - 1) * B * W);
    f.f_stride = 2LL * W;
    f.f_step = 2;
    f.cell = reinterpret_cast<unsigned*>(front + cells);
    f.jumps = reinterpret_cast<int8_t*>(front + ((cells + B + 2) & ~size_t{1}));
  }
  // 16-byte copies of the parents where each row starts 16-byte aligned
  if (parent_pitch(W) % 16 == 0)
    return rightmost ? launch_finish<true, 16>(f, s)
                     : launch_finish<false, 16>(f, s);
  return rightmost ? launch_finish<true, 4>(f, s)
                   : launch_finish<false, 4>(f, s);
}
