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
// What bounds them on an H100: latency.  A block is Kb dependent rows, and
// the K-row blocks of a seam run one after the other (each needs the last
// row of the one before, which the halo exchange between launches carries
// across shards).  At the 8K shard shape (Wl = 1920, K = 96, Hh = 192) a
// block moves ~3.5 MB for 4 shards, about a microsecond of bandwidth,
// against 96 dependent rows, so what a launch costs is what a row costs
// times Kb.  A CTA a shard pays a barrier over all its threads every row
// (~600 ns a row at that shape); a warp pays two shuffles.  The walk reads
// ~75 KB and does Kb dependent steps of one thread: its time is one trip
// to device memory (in the carve its rows have left the 50 MB L2: the
// seam's M is 4 x 4320 x 2304 f32 = 159 MB) plus Kb steps of shared-memory
// latency.
//
// The block DP over column tiles, one CTA a tile (grid: tiles x S).  No
// tile needs another's cells: a DP value |dc| columns from exact data is
// exact for |dc| rows (the trapezoid argument of parallel/spatial.py
// :15-19), so a tile that runs the recurrence over its owned columns plus
// Hg >= Kb ghost columns a side, with +inf beyond them, gets every owned
// cell of all Kb rows bitwise equal to the recurrence over the whole
// extended row.  Ghost columns past the extended row's ends are dropped:
// they are +inf there too.  So the tiles exchange nothing, wait for no one
// and need no scratch or cooperative launch; the ghost zones cost compute
// (4x at the 8K shape), which a latency-bound row has to spare.
//
// Geometry (T, Wt, Hg: the launch's plan, from kernels/spatial_kernel.py::
// tile_plan, the one place that picks them; T is the grid's x dimension).
// Tile t of T owns [a, b) (struct Tile, whose twin is spatial_kernel.py::
// tile_bounds): Wt columns from t*Wt + Hg, the first from 0 and the last to
// We, so the two edge tiles also own the Hg columns their missing outer
// ghost zone frees.  It computes the span [x0, x1) = [max(a - Hg, 0),
// min(b + Hg, We)), at most Wt + 2*Hg <= 256 columns, in one warp: lane l
// holds the kTileColumns = 8 contiguous columns x0 + 8l .. + 7 (lanes past
// x1 hold +inf).  At the 8K shape Hg = 96, Wt = 64: 33 tiles a shard, 132
// CTAs, one an SM of an H100 SXM (36 tiles of 64 columns, 144 CTAs, took
// 7 % longer).
// Each tile runs find_seam_tiled.cu's split schedule, adapted to write M
// rows instead of parent bytes: a CTA of 1 + kTileHelpers warps.
//   - The DP warp, each row: two shuffles for its lanes' edge cells (+inf
//     beyond lanes 0 and 31), one ld.shared.v4 a 4-column group of the
//     energy, chunk_row (dp_rows.cuh: m = e + min(min(left, centre),
//     right), each op rounded on its own, +inf outside [0, width)), and one
//     st.shared.v4 a group of the new row into the rows ring where the
//     group holds owned columns.  No barrier a row.
//   - The helper warps stage each group of kGroup energy rows kStages - 1
//     groups ahead with cp.async, each thread the same 4-column units of
//     every row from a pointer and a row step worked out once (the
//     message's row, or the left halo, the energy block or the right halo,
//     whichever holds the unit), and store the owned columns of each
//     group's M rows from the rows ring to device memory (16 bytes a store
//     where out's rows allow it).
//   An energy ring of kStages slots and a rows ring of kDepth = 3, a group
//   a slot; named barriers E(j) (IDs 1-2, the helpers arrive once group
//   j's energy has landed, the DP warp syncs before it) and R(j) (IDs 3-4,
//   the DP warp arrives after group j's rows are in the rows ring, the
//   helpers sync before they announce E(j + 2), stage group j + kStages
//   into group j's energy slot and store group j).  The order of arrivals
//   and the proof that no slot is reused early are those of
//   find_seam_tiled.cu's header (the rows ring's, word for word; the
//   energy ring's slot is restaged only after R(j)); a group costs the DP
//   warp one bar.sync and one bar.arrive.
// A block too tall for a warp's 256 columns to hold 64 owned columns and
// their ghost zones (Kb > 96) on a row wider than 256 columns falls back
// to one CTA a shard (T = 0): the chunked row step of dp_rows.cuh over the
// whole extended row, one barrier a row (tile_plan's last case).  Where
// both can run, tiles were faster at every shape timed (PERF.md §6).
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
constexpr int kTileColumns = 8;  // columns a lane of a tile's DP warp
constexpr int kTileHelpers = 3;  // helper warps a tile
constexpr int kTileThreads = 32 * (1 + kTileHelpers);

// #16: row r of the message; r = 0 is the frontier.  step(j): floats
// between rows r and r + 1 of column j, r >= 1.
struct MessageRows {
  const float* msg;
  int We;
  __device__ __forceinline__ const float* at(int r, int j) const {
    return msg + static_cast<size_t>(r) * We + j;
  }
  __device__ __forceinline__ int step(int) const { return We; }
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
  __device__ __forceinline__ int step(int j) const {
    return j < Hh || j >= Hh + Wl ? Hh : Wl;
  }
};

// cp.async columns [c, c + 4) of row k of `src` (those < We) to dst: one
// 16-byte copy where the group lies in one source, aligned.
template <class Rows>
__device__ __forceinline__ void load_group(const Rows& src, int k, float* dst,
                                           int c, int We) {
  const float* from = src.at(k, c);
  if (c + 3 < We && src.at(k, c + 3) == from + 3
      && reinterpret_cast<uintptr_t>(from) % 16 == 0) {
    cp_async16(dst, from);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < We) cp_async4(dst + i, src.at(k, c + i));
}

// Columns [c, c + 4) of a row of out (those < We), 16 bytes at a time
// where out's rows allow it.
__device__ __forceinline__ void store_group(float* to, float4 v, int c,
                                            int We, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(to) = v;
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < We) to[i] = f[i];
  }
}

// Moves the rows of one shard for dp_rows: extended rows in, each column
// from wherever `Rows` says it lies; rows of M out (row k of the recurrence
// is row k - 1 of out).
template <class Rows>
struct BlockIo {
  Rows src;
  float* out;
  int We;
  bool vec;
  __device__ __forceinline__ void load(int k, float* dst, int c) const {
    load_group(src, k, dst, c, We);
  }
  __device__ __forceinline__ void store(int k, float4 v, int c) const {
    store_group(out + static_cast<size_t>(k - 1) * We + c, v, c, We, vec);
  }
};

// One CTA a shard: Kb DP rows of the whole extended row from rows 0 .. Kb
// of `src` (row 0 the frontier) into out (row r at out + r*We); extended
// column j is global column col0 + j, live when inside [0, width).
template <int C, class Rows>
__device__ void block_rows(const Rows& src, float* __restrict__ out, int Kb,
                           int We, int col0, int width, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = threadIdx.x * C;
  const Window win(-col0, min(width - col0, We), j0, C);
  float m[C];
#pragma unroll
  for (int i = 0; i < C; ++i)
    m[i] = win.has(i) ? *src.at(0, j0 + i) : INFINITY;
  dp_rows<C, false, false>(BlockIo<Rows>{src, out, We, vec}, m, Kb, We, win,
                           smem);
}

// The tiled schedule's two rings, energy then rows: kStages and kDepth
// slots of a group of kGroup rows each, a row's 32 chunks kPitch floats
// apart (dp_rows.cuh's bank-conflict-free pitch), as the DP warp's lanes
// hold them.  The energy ring is the deeper: a group is staged kStages - 1
// groups ahead, so that energy rows read from HBM land in time.
struct TileRing {
  static constexpr int C = kTileColumns;
  static constexpr int kPitch = Chunk<C>::kPitch;
  static constexpr int kRow = 32 * kPitch;  // floats a row
  static constexpr int kGroup = 64 / C;     // rows a group
  static constexpr int kStages = 4;         // groups the energy ring holds
  static constexpr int kDepth = 3;          // groups the rows ring holds
  static constexpr int kSlot = kGroup * kRow;
  static constexpr size_t kBytes =
      sizeof(float) * (kStages + kDepth) * kSlot;
  // where span column c >= 0 sits in a row
  __device__ static constexpr int at(int c) {
    return c / C * kPitch + c % C;
  }
};
constexpr int kEnergyBar = 1;  // E(j): named barrier kEnergyBar + j % 2
constexpr int kRowsBar = 3;    // R(j): named barrier kRowsBar + j % 2

// Named barriers in their non-.aligned form: a warp's threads may reach
// them apart.
static __device__ __forceinline__ void named_sync(int id) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "n"(kTileThreads)
               : "memory");
}

static __device__ __forceinline__ void named_arrive(int id) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "n"(kTileThreads)
               : "memory");
}

// Tile t of T: owned columns [a, b) of the extended row, computed over the
// span [x0, x1) (spatial_kernel.py::tile_bounds is its twin): Wt owned
// columns each, and the first and the last also the Hg columns that their
// missing outer ghost zone frees, so every span is at most Wt + 2 Hg
// columns.
struct Tile {
  int a, b, x0, x1;
  __device__ Tile(int t, int T, int Wt, int Hg, int We)
      : a(t == 0 ? 0 : t * Wt + Hg),
        b(t == T - 1 ? We : (t + 1) * Wt + Hg),
        x0(max(a - Hg, 0)),
        x1(min(b + Hg, We)) {}
};

// The tile's DP warp: row 0 from `src`, then rows 1 .. Kb, a group of G
// rows between E(j) and R(j); the energy of group j from its slot of the
// energy ring, the new rows' owned groups into slot j % 3 of the rows ring.
template <class Rows>
__device__ __forceinline__ void tile_dp(const Rows& src, int Kb,
                                        const Tile& tl, int col0, int width,
                                        const float* ering, float* rring) {
  using Ring = TileRing;
  constexpr int C = Ring::C;
  constexpr int G = Ring::kGroup;
  const unsigned all = 0xffffffffu;
  const float inf = INFINITY;
  const int lane = threadIdx.x;
  const int j0 = lane * C;
  const int g0 = col0 + tl.x0;  // the span's first global column
  const Window win(-g0, min(width - g0, tl.x1 - tl.x0), j0, C);
  float m[C];
#pragma unroll
  for (int i = 0; i < C; ++i)
    m[i] = win.has(i) ? *src.at(0, tl.x0 + j0 + i) : inf;
  bool own[C / 4];  // which of the lane's groups hold owned columns
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const int c = tl.x0 + j0 + 4 * q;
    own[q] = c + 4 > tl.a && c < tl.b;
  }
  const float* const e_lane = ering + lane * Ring::kPitch;
  float* const r_lane = rring + lane * Ring::kPitch;
  const auto rows = [&](auto masked) {
    constexpr bool MASKED = decltype(masked)::value;
    for (int n0 = 0, j = 0; n0 < Kb; n0 += G, ++j) {
      const int eslot = j % Ring::kStages * Ring::kSlot;
      const int slot = j % Ring::kDepth * Ring::kSlot;
      named_sync(kEnergyBar + j % 2);  // the group has landed
      alignas(16) float e[G][C];  // rows past Kb read stale slots: unused
#pragma unroll
      for (int s = 0; s < G; ++s)
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          *reinterpret_cast<float4*>(&e[s][4 * q]) =
              *reinterpret_cast<const float4*>(e_lane + eslot +
                                               s * Ring::kRow + 4 * q);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (n0 + s >= Kb) break;
        float left = __shfl_up_sync(all, m[C - 1], 1);
        float right = __shfl_down_sync(all, m[0], 1);
        if (lane == 0) left = inf;
        if (lane == 31) right = inf;
        float4 o[C / 4];
        chunk_row<C, false, false, MASKED>(m, e[s], win, left, right, o);
        float* to = r_lane + slot + s * Ring::kRow;
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          if (own[q]) *reinterpret_cast<float4*>(to + 4 * q) = o[q];
      }
      named_arrive(kRowsBar + j % 2);  // rows out, energy read
    }
  };
  if (__all_sync(all, win.a == 0 && win.b == C))
    rows(std::false_type{});
  else
    rows(std::true_type{});
}

// The tile's helper warps: groups 0 .. kStages - 1 staged and E(0), E(1)
// announced first; then after R(j) group j + 2 announced, group j +
// kStages staged into group j's slot, and group j's owned M rows stored.
// Thread h of the helpers stages the span's 4-column units h, h + 32
// kTileHelpers, ... of every row, each from a pointer and a row step
// worked out once, and stores the owned units h, h + 32 kTileHelpers, ...
// of a group's rows.
template <class Rows>
__device__ __forceinline__ void tile_helpers(const Rows& src,
                                             float* __restrict__ out, int Kb,
                                             int We, const Tile& tl, bool vec,
                                             float* ering,
                                             const float* rring) {
  using Ring = TileRing;
  constexpr int C = Ring::C;
  constexpr int G = Ring::kGroup;
  constexpr int D = Ring::kStages;
  static_assert(D >= 3 && Ring::kDepth == 3,
                "E(j + 2) is announced after R(j), and the DP warp writes "
                "group j + 3's rows after E(j + 3), so after group j's store");
  constexpr int HT = 32 * kTileHelpers;
  constexpr int U = (8 * C + HT - 1) / HT;  // a thread's units of a row
  const int h = threadIdx.x - 32;
  const int J = (Kb + G - 1) / G;
  const int units = (tl.x1 - tl.x0 + 3) / 4;  // of the span

  // unit i of this thread: span column 4(h + i HT), its row 1 at p[i], row
  // r at p[i] + (r - 1) step[i]; one 16-byte copy a row where the unit lies
  // in one source, aligned, else 4-byte copies by Rows::at
  const float* p[U];
  int step[U];
  bool v16[U];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int x = tl.x0 + 4 * (h + i * HT);
    p[i] = src.at(1, x);
    step[i] = src.step(x);
    v16[i] = x + 3 < We && src.at(1, x + 3) == p[i] + 3 && step[i] % 4 == 0
             && reinterpret_cast<uintptr_t>(p[i]) % 16 == 0;
  }
  // one cp.async group a call, empty past the last group
  const auto stage = [&](int j) {  // rows jG + 1 .. of the message
    const int n0 = j * G;
    float* dst = ering + j % D * Ring::kSlot;
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = 4 * (h + i * HT);
      if (j >= J || c >= 4 * units) break;
      float* d = dst + Ring::at(c);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (n0 + s >= Kb) break;
        if (v16[i])
          cp_async16(d + s * Ring::kRow,
                     p[i] + static_cast<size_t>(n0 + s) * step[i]);
        else
          load_group(src, n0 + s + 1, d + s * Ring::kRow, tl.x0 + c, We);
      }
    }
    cp_async_commit();
  };
  // the owned units [ua, ua + nu) of a group's rows: (row s, unit q) from
  // (s0, q0), on by (ds, dq)
  const int ua = (tl.a - tl.x0) / 4;
  const int nu = (tl.b - tl.x0 + 3) / 4 - ua;
  const int s0 = h / nu, q0 = h % nu, ds = HT / nu, dq = HT % nu;
  const auto store = [&](int j) {  // rows jG .. of out
    const int n0 = j * G;
    const int n = min(G, Kb - n0);
    const float* rows = rring + j % Ring::kDepth * Ring::kSlot;
    for (int s = s0, q = q0; s < n;) {
      const int c = 4 * (ua + q);
      const float4 v =
          *reinterpret_cast<const float4*>(rows + s * Ring::kRow + Ring::at(c));
      const int x = tl.x0 + c;
      store_group(out + static_cast<size_t>(n0 + s) * We + x, v, x, We, vec);
      s += ds;
      q += dq;
      if (q >= nu) {
        q -= nu;
        ++s;
      }
    }
  };

  for (int j = 0; j < D; ++j) stage(j);
  cp_async_wait<D - 2>();  // groups 0 and 1 have landed
  if (J > 0) named_arrive(kEnergyBar);
  if (J > 1) named_arrive(kEnergyBar + 1);
  for (int j = 0; j < J; ++j) {
    named_sync(kRowsBar + j % 2);  // the DP warp is past group j
    if (j + 2 < J) {
      cp_async_wait<D - 3>();  // group j + 2 of the D + j committed
      named_arrive(kEnergyBar + j % 2);
    }
    stage(j + D);  // into group j's slot
    store(j);
  }
  cp_async_wait<0>();
}

// Kb DP rows of shard s of a stack: with TILED tile blockIdx.x of shard
// blockIdx.y (C = kTileColumns), else one CTA the shard (blockIdx.x = s),
// C columns a thread.
template <int C, bool TILED, class Rows>
__device__ __forceinline__ void shard_rows(const Rows& src, float* out,
                                           int Kb, int We, int col0,
                                           int width, int Wt, int Hg) {
  const bool vec = We % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if constexpr (!TILED) {
    block_rows<C>(src, out, Kb, We, col0, width, vec);
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    float* ering = reinterpret_cast<float*>(smem);
    float* rring = ering + TileRing::kStages * TileRing::kSlot;
    const Tile tl(blockIdx.x, gridDim.x, Wt, Hg, We);
    if (threadIdx.x < 32)
      tile_dp(src, Kb, tl, col0, width, ering, rring);
    else
      tile_helpers(src, out, Kb, We, tl, vec, ering, rring);
  }
}

template <int C, bool TILED>
__global__ void __launch_bounds__(TILED ? kTileThreads : kMaxThreads)
block_dp_kernel(const float* __restrict__ msg, float* __restrict__ out,
                long long out_ss, int Kb, int Wl, int Hh, int lo,
                const int* __restrict__ width, int Wt, int Hg) {
  const int s = TILED ? blockIdx.y : blockIdx.x;
  const int We = Wl + 2 * Hh;
  const MessageRows src{msg + static_cast<size_t>(s) * (Kb + 1) * We, We};
  shard_rows<C, TILED>(src, out + s * out_ss, Kb, We, lo + s * Wl - Hh,
                       *width, Wt, Hg);
}

template <int C, bool TILED>
__global__ void __launch_bounds__(TILED ? kTileThreads : kMaxThreads)
block_dp_parts_kernel(const float* __restrict__ prev, long long prev_ss,
                      const float* __restrict__ E, long long e_ss,
                      const float* __restrict__ lh,
                      const float* __restrict__ rh, float* __restrict__ out,
                      long long out_ss, int Kb, int Wl, int Hh, int lo,
                      const int* __restrict__ width, int Wt, int Hg) {
  const int s = TILED ? blockIdx.y : blockIdx.x;
  const size_t halo = static_cast<size_t>(s) * (Kb + 1) * Hh;
  const PartRows src{prev + s * prev_ss, E + s * e_ss, lh + halo, rh + halo,
                     Wl, Hh};
  shard_rows<C, TILED>(src, out + s * out_ss, Kb, Wl + 2 * Hh,
                       lo + s * Wl - Hh, *width, Wt, Hg);
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

// Launch block kernel `kernel<C, TILED>` over S shards in the plan
// (T, Wt, Hg): T = 0 one CTA a shard, with the chunk width and CTA that the
// extended row's We columns take; else T tiles a shard.
// cudaErrorInvalidValue for a plan whose tiles do not fit a warp, leave
// the last tile no owned column or have ghost zones narrower than the
// block.
template <class Launch>
int launch_rows(int S, int Kb, int We, int T, int Wt, int Hg, Launch go) {
  if (T == 0)
    return with_chunk(We, [&](auto c) {
      const int threads = threads_for<decltype(c)::value>(We);
      return go(c, std::false_type{}, dim3(S),
                threads, ring_bytes<decltype(c)::value>(threads));
    });
  constexpr int span = 32 * kTileColumns;
  // tiles past the first start at multiples of 4 (16-byte rows); the last
  // owns [(T-1) Wt + Hg, We) over the span [(T-1) Wt, We)
  const bool fits =
      T == 1 ? We <= span
             : Wt % 4 == 0 && Hg % 4 == 0 && Wt + 2 * Hg <= span
                   && (T - 1) * Wt + Hg < We && We - (T - 1) * Wt <= span;
  if (T < 0 || !fits || Hg < Kb || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return go(std::integral_constant<int, kTileColumns>{}, std::true_type{},
            dim3(T, S), kTileThreads, TileRing::kBytes);
}

}  // namespace dct_carver

// msg: (S, Kb+1, We) f32, row 0 the frontier; out: row r of shard s at
// out + s*out_ss + r*We.  width: one int32 on the device.  (T, Wt, Hg):
// the schedule (launch_rows).  We <= 32768.  Returns the cudaError_t of
// the plan's check, the attribute call or the launch.
extern "C" int dc_block_dp(const float* msg, float* out, long long out_ss,
                           int S, int Kb, int Wl, int Hh, int lo,
                           const int* width, int T, int Wt, int Hg,
                           void* stream) {
  using namespace dct_carver;
  return launch_rows(S, Kb, Wl + 2 * Hh, T, Wt, Hg,
                     [&](auto c, auto tiled, dim3 grid, int threads,
                         size_t smem) {
    const auto kernel =
        block_dp_kernel<decltype(c)::value, decltype(tiled)::value>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        msg, out, out_ss, Kb, Wl, Hh, lo, width, Wt, Hg);
    return static_cast<int>(cudaGetLastError());
  });
}

// prev: shard s's frontier at prev + s*prev_ss (Wl f32); E: its energy
// block at E + s*e_ss (Kb rows of Wl); lh, rh: (S, Kb+1, Hh) f32; out and
// the plan as dc_block_dp.  Returns the cudaError_t of the plan's check,
// the attribute call or the launch.
extern "C" int dc_block_dp_parts(const float* prev, long long prev_ss,
                                 const float* E, long long e_ss,
                                 const float* lh, const float* rh, float* out,
                                 long long out_ss, int S, int Kb, int Wl,
                                 int Hh, int lo, const int* width, int T,
                                 int Wt, int Hg, void* stream) {
  using namespace dct_carver;
  return launch_rows(S, Kb, Wl + 2 * Hh, T, Wt, Hg,
                     [&](auto c, auto tiled, dim3 grid, int threads,
                         size_t smem) {
    const auto kernel =
        block_dp_parts_kernel<decltype(c)::value, decltype(tiled)::value>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        prev, prev_ss, E, e_ss, lh, rh, out, out_ss, Kb, Wl, Hh, lo, width,
        Wt, Hg);
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
