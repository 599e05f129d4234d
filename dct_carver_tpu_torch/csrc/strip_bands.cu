// The strip update of a plugged energy, in two copies around the energy's
// own bands function, and the DCT chains over gathered bands:
//
//   dc_strip_gather  replaces dct_carver_tpu/pallas/strip_kernel.py::
//                    _gather_slabs_call (pl.pallas_call at :138, kernel
//                    _make_gather_kernel :69): the luma window of every
//                    strip, ready for a bands function;
//   dc_strip_scatter replaces _scatter_strips_call (:288, _make_scatter_kernel
//                    :201): the read-modify-write of the recomputed strips
//                    into the energy;
//   dc_band_energy   replaces _strip_energy_call (:401,
//                    _make_strip_energy_kernel :351): the DCT energy of
//                    gathered bands, from the same chains and pick
//                    (energy_chain.cuh) as energy.cu and strip.cu.
//
// Geometry: the port's per-row strip (ops/carve.py::_strip_bounds), not the
// TPU's R-row blocks, 256-lane windows and lane rotations, which exist for
// its vector layout.  Row i's strip is columns [start_i, start_i + strip_w)
// with start_i = clamp(seam_i - half, 0, W - strip_w); its band holds rows
// i + co .. i + co + n - 1 and columns start_i + co .. start_i + co +
// strip_w + n - 2, each clamped to the plane (the full map's border rule).
//
// What bounds the gather and the scatter on an H100: the launch.  At 1080p
// a strip of n=2 is 1080 x 2 x 9 floats to gather and 1080 x 8 to scatter:
// their bytes take tens of nanoseconds, under the ~0.9 us an empty kernel
// takes on the card, and timed back to back they take 40-50 times their
// device time, in the host's wrapper and launch.  So a carve on the card
// runs them as nodes of the seam step's CUDA graph (ops/carve.py::
// SeamSteps, parallel/spatial.py): their geometry is static (the seam is
// read on the device, W is the buffer's width), and a replay launches them
// with no host work.  A batch of 256 1-Mpix images moves ~4.7e6 floats a
// seam each way, a few microseconds of bandwidth.
//
// Their design: one thread per output element, the flat index running
// along the band (or strip) row, so a warp's 32 lanes read neighbouring
// luma columns and write 128 contiguous bytes whatever the band's width.
// Three 2-D layouts were measured against it (one row of threads a band
// row, blocks of (column, dy, row) threads, and rows whose strip starts are
// staged in shared memory): none was faster at the main path's n = 2, and
// the row layouts were up to twice as slow at 256 images, where a 9-float
// band row leaves most of a warp idle and writes short segments.  The
// gather and the scatter are pure copies, so they are bitwise by
// construction; every scatter thread writes its own energy cell, so the
// in-place update is race free.  The image is the grid's z dimension with
// size_t plane offsets (B * H * W passes INT_MAX near B = 1024 1-Mpix
// images); band rows are flattened into one size_t index.
//
// Shard offset (the spatial route, as strip.cu): the B images may be the
// column shards of one image.  The gather then reads each shard's luma with
// its edge-clamped r-1 / r column halo and places every band column by its
// global column; the scatter writes only the strip columns the shard owns.
// Band columns outside a shard's luma are clamped, and only feed strip
// columns that its scatter drops.
//
// What bounds the band energy: latency for one image, arithmetic for a
// batch.  A band row of C columns has C - n + 1 outputs, each n*n - 1 atom
// chains over the n*C vertical chains that the row's outputs share: at
// n=8 and 1080p (bands (1080, 8, 27)) 2.4e7 separately rounded ops, about
// 0.7 us of the float32 pipe's unfused rate, under two launches; 256
// 1-Mpix images are 256x that.
//
// Its design: strip.cu's row teams without the gather and the scatter.  A
// band row's outputs are cut into tiles of at most 1024/n, so that a
// tile's (output, ky) pairs fit one team of at most 1024 threads, and a
// block takes as many tiles as fill ~kBandThreads threads (small n packs
// several rows, so one 1080-row call spreads over the SMs; a full-row band
// spreads over many blocks).  The team first computes the vertical chains
// V[ky][c] of the tile's tc + n - 1 band columns once, into shared memory
// at a padded pitch (v_pitch): one thread a column loads its n values,
// coalesced along the row, and runs its n chains with the taps as
// operands.  After one barrier, each output's atom chains run on g lanes
// (team_pick, strip.cu's pair body): lane (c, j) runs the n atom chains of
// each of its n/g rows ky over V[ky][c..c+n-1] from registers, and the g
// lanes combine their picks by shuffles.  So an output costs n^2 atom
// chains and its share of n*C vertical ones, where one thread an output
// (the design before this one) ran n^2 + n^2, 1920 ops at n=8.  A call
// bound by latency (one image) takes g = n, one lane a ky, the most
// threads; a larger one g = 1 (band_lanes).  The taps are a kernel
// parameter (constant memory), an operand of every multiply.  On an NVIDIA
// H100 80GB HBM3 (chip_smoke.py --band-variants builds copies of this file
// with other block shapes): splitting a column's vertical chains over n/2
// threads made the tap index a run-time value and was slower at every n;
// 128 to 512 threads a block were within a few per cent; g = n was fastest
// at 1080p (n = 2-16), g = 1 from 8 1-Mpix images on; other g were no
// faster.

#include <climits>

#include <algorithm>

#include <cuda_runtime.h>

#include "dp_rows.cuh"
#include "energy_chain.cuh"

namespace dct_carver {

__device__ __forceinline__ int strip_start(int seam, int half, int W,
                                           int strip_w) {
  return min(max(seam - half, 0), max(W - strip_w, 0));
}

__global__ void strip_gather_kernel(const float* __restrict__ luma,
                                    const int* __restrict__ seam,
                                    float* __restrict__ bands, int H, int Wx,
                                    int Wg, int lo, int lo_step, int xoff,
                                    int seam_step, int n, int co, int half,
                                    int strip_w) {
  const int cb = strip_w + n - 1;  // band width
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * n * cb) return;
  const int t = e % cb;
  const int dy = (e / cb) % n;
  const int i = e / (cb * n);
  const size_t b = blockIdx.z;
  const int start = strip_start(seam[b * seam_step + i], half, Wg, strip_w);
  // luma column 0 of image b is global column lo + b*lo_step - xoff
  const int x0 = lo + static_cast<int>(b) * lo_step - xoff;
  const int row = min(max(i + co + dy, 0), H - 1);
  const int col = min(max(start + co + t - x0, 0), Wx - 1);
  bands[b * H * n * cb + e] =
      __ldg(luma + b * H * Wx + static_cast<size_t>(row) * Wx + col);
}

__global__ void strip_scatter_kernel(float* __restrict__ energy,
                                     const float* __restrict__ strip,
                                     const int* __restrict__ seam, int H,
                                     int W, int Wg, int lo, int lo_step,
                                     int seam_step, int half, int strip_w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * strip_w) return;
  const int c = e % strip_w;
  const int i = e / strip_w;
  const size_t b = blockIdx.z;
  const int col = strip_start(seam[b * seam_step + i], half, Wg, strip_w) +
                  c - (lo + static_cast<int>(b) * lo_step);
  if (col < 0 || col >= W) return;
  energy[b * H * W + static_cast<size_t>(i) * W + col] =
      strip[b * H * strip_w + e];
}

// The row pitch, in floats, of n rows of `cols` vertical chains in shared
// memory: a warp's lanes (c, ky) read V[ky][c + dx], and a pitch of 32/n
// mod 32 puts the n rows on distinct banks (strip.cu's strip_shape).
inline int v_pitch(int n, int cols) {
  return cols + ((32 / n - cols % 32) % 32 + 32) % 32;
}

// The pick of output c of a row team, on G lanes (strip.cu's pair body):
// lane (c, j) runs the N atom chains of each of the rows ky = j*N/G ..
// (j+1)*N/G - 1 over V[ky][c .. c + N - 1] (row pitch vp) from registers,
// the taps as operands, and the G lanes of the output, G-aligned in one
// warp, combine their picks by shuffles, so each of them returns the
// output's pick.  Every lane of the warp calls it; `mine` is false on the
// idle ones, which add nothing.
template <int N, int G>
__device__ __forceinline__ Pick team_pick(const float* V, int vp, int c,
                                          int j, bool mine,
                                          const Taps<N>& taps) {
  Pick p;
  if (mine) {
#pragma unroll 1
    for (int t = 0; t < N / G; ++t) {
      const int ky = j * (N / G) + t;
      const float* vr = V + ky * vp + c;
      float v[N];
#pragma unroll
      for (int dx = 0; dx < N; ++dx) v[dx] = vr[dx];
      pick_row<N>(p, ky, [&](int kx) {
        return chain<N>(taps, kx, [&](int dx) { return v[dx]; });
      });
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, p.v, off);
    const int orank = __shfl_xor_sync(0xffffffffu, p.rank, off);
    p.add(ov, orank);
  }
  return p;
}

constexpr int kBandThreads = 256;  // the threads a block aims at
constexpr size_t kBandSmem = 48 * 1024;  // no opt-in attribute needed
// From this many outputs, a quarter of the card's 132 x 2048 resident
// threads, one thread an output keeps the card busy enough
constexpr size_t kBandLargeOutputs = 65536;

// The lanes of an output: n, one a ky, while the call is bound by latency
// (1080p: 8 640 to 38 880 outputs); one in a larger call (8 1-Mpix images:
// 65 536 to 294 912; 256 of them: 2.1e6 to 9.4e6), which is bound by its
// instructions, and where a lane's own work (its index, its V loads, the
// picks' shuffles) is then paid once for n rows, not once a row.
inline int band_lanes(int n, size_t outputs) {
  return outputs < kBandLargeOutputs ? n : 1;
}

// One band launch's shape with g lanes an output: a row's cout outputs in
// `tiles` tiles of at most `tc`, so that tc*n <= 1024 and the team of
// team = tc*g threads a tile fits the kernel's `max_threads` (its
// registers may allow fewer than 1024), R tiles a block, the V row pitch
// `vp`, and `magic` = ceil(2^31 / team), so that a thread's tile of the
// block is __umulhi(2 * thread, magic) (exact for thread, team <= 1024).
struct BandShape {
  int tiles, tc, team, R, threads, vp;
  unsigned magic;
  size_t smem;
};

inline BandShape band_shape(int n, int g, int C, int max_threads) {
  BandShape s;
  const int cout = C - n + 1;
  const int tile_max = std::min(kMaxThreads / n, max_threads / g);
  s.tiles = (cout + tile_max - 1) / tile_max;
  s.tc = (cout + s.tiles - 1) / s.tiles;
  s.team = s.tc * g;
  s.magic = static_cast<unsigned>(((1ull << 31) + s.team - 1) / s.team);
  s.vp = v_pitch(n, s.tc + n - 1);
  const size_t tile_bytes = static_cast<size_t>(n) * s.vp * sizeof(float);
  s.R = std::max(1, std::min(std::min(kBandThreads, max_threads) / s.team,
                             static_cast<int>(kBandSmem / tile_bytes)));
  s.threads = (s.R * s.team + 31) / 32 * 32;
  s.smem = s.R * tile_bytes;
  return s;
}

template <int N, int G>
__global__ void band_energy_kernel(const float* __restrict__ bands,
                                   float* __restrict__ out,
                                   const Taps<N> taps, size_t units, int C,
                                   int tiles, int tc, int R, int team,
                                   unsigned magic, int vp, float edges,
                                   float textures) {
  extern __shared__ __align__(16) float sm[];
  const int cout = C - N + 1;
  // this thread's tile r of the block: tile u of the call, outputs
  // [p0, p0 + tw) of band row `row`; tw = 0 past the call's or block's tiles
  const int r = static_cast<int>(__umulhi(2 * threadIdx.x, magic));
  const int lane = threadIdx.x - r * team;
  const size_t u = static_cast<size_t>(blockIdx.x) * R + r;
  size_t row = u;
  int p0 = 0, tw = 0;
  if (r < R && u < units) {
    if (tiles > 1) {  // a wide row: the only 64-bit division
      row = u / tiles;
      p0 = static_cast<int>(u - row * tiles) * tc;
    }
    tw = max(min(tc, cout - p0), 0);
  }
  float* V = sm + r * N * vp;  // N x vp

  // the vertical chains of the tile's band columns, once: thread c loads
  // column c (coalesced along c) and computes V[0..N-1][c], the taps as
  // operands
  if (tw > 0) {
    for (int c = lane; c < tw + N - 1; c += team) {
      const float* src = bands + row * N * C + p0 + c;
      float x[N];
#pragma unroll
      for (int dy = 0; dy < N; ++dy) x[dy] = __ldg(src + dy * C);
#pragma unroll
      for (int k = 0; k < N; ++k)
        V[k * vp + c] = chain<N>(taps, k, [&](int dy) { return x[dy]; });
    }
  }
  __syncthreads();

  // the atom chains of output c's rows ky on lane (c, j), its G picks
  // combined by shuffles on G aligned lanes of one warp
  const int c = lane / G;
  const bool mine = c < tw;
  const Pick p = team_pick<N, G>(V, vp, c, lane % G, mine, taps);
  if (mine && lane % G == 0)
    out[row * cout + p0 + c] = p.energy<N>(edges, textures);
}

template <int N, int G>
int launch_band(const float* bands, float* out, const Taps<N>& taps,
                size_t rows, int C, float edges, float textures,
                cudaStream_t stream) {
  // the most threads a block of this kernel may have, read once
  static int max_threads = 0;
  if (max_threads == 0) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, band_energy_kernel<N, G>);
    if (e != cudaSuccess) return static_cast<int>(e);
    max_threads = a.maxThreadsPerBlock / 32 * 32;
  }
  const BandShape s = band_shape(N, G, C, max_threads);
  const size_t units = rows * s.tiles;
  const size_t blocks = (units + s.R - 1) / s.R;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  band_energy_kernel<N, G><<<static_cast<unsigned>(blocks), s.threads,
                             s.smem, stream>>>(
      bands, out, taps, units, C, s.tiles, s.tc, s.R, s.team, s.magic, s.vp,
      edges, textures);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_band_n(const float* bands, float* out, const float* taps_host,
                  size_t rows, int C, float edges, float textures,
                  cudaStream_t stream) {
  Taps<N> taps;
  for (int i = 0; i < N * N; ++i) taps.d[i] = taps_host[i];
  if (band_lanes(N, rows * (C - N + 1)) == N)
    return launch_band<N, N>(bands, out, taps, rows, C, edges, textures,
                             stream);
  return launch_band<N, 1>(bands, out, taps, rows, C, edges, textures,
                           stream);
}

}  // namespace dct_carver

// luma: (B, H, Wx) f32; seam: int32, image b's at seam + b*seam_step;
// bands: (B, H, n, strip_w+n-1) f32.  Image b's luma column xoff is global
// column lo + b*lo_step; strip starts are clamped to the global width Wg.
// One image: Wx = Wg = W, lo = lo_step = xoff = 0, seam_step = H.  Returns
// the cudaError_t of the launch.
extern "C" int dc_strip_gather(const float* luma, const int* seam,
                               float* bands, int B, int H, int Wx, int Wg,
                               int lo, int lo_step, int xoff, int seam_step,
                               int n, int co, int half, int strip_w,
                               void* stream) {
  using namespace dct_carver;
  const int total = H * n * (strip_w + n - 1);
  const dim3 block(256);
  const dim3 grid((total + block.x - 1) / block.x, 1, B);
  strip_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, seam, bands, H, Wx, Wg, lo, lo_step, xoff, seam_step, n, co, half,
      strip_w);
  return static_cast<int>(cudaGetLastError());
}

// energy: (B, H, W) f32, updated in place; strip: (B, H, strip_w) f32;
// seam: int32, image b's at seam + b*seam_step.  Image b's energy column 0
// is global column lo + b*lo_step; it keeps the strip columns it owns.  One
// image: Wg = W, lo = lo_step = 0, seam_step = H.  Returns the cudaError_t
// of the launch.
extern "C" int dc_strip_scatter(float* energy, const float* strip,
                                const int* seam, int B, int H, int W, int Wg,
                                int lo, int lo_step, int seam_step, int half,
                                int strip_w, void* stream) {
  using namespace dct_carver;
  const int total = H * strip_w;
  const dim3 block(256);
  const dim3 grid((total + block.x - 1) / block.x, 1, B);
  strip_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      energy, strip, seam, H, W, Wg, lo, lo_step, seam_step, half, strip_w);
  return static_cast<int>(cudaGetLastError());
}

// bands: (rows, n, C) f32 and out: (rows, C-n+1) f32 on the device; taps:
// (n, n) f32 in host memory (passed to the kernel by value).  Returns the
// cudaError_t of the launch.
extern "C" int dc_band_energy(const float* bands, float* out,
                              const float* taps, long long rows, int n,
                              int C, float edges, float textures,
                              void* stream) {
  using namespace dct_carver;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t r = static_cast<size_t>(rows);
  switch (n) {
    case 2: return launch_band_n<2>(bands, out, taps, r, C, edges, textures, s);
    case 4: return launch_band_n<4>(bands, out, taps, r, C, edges, textures, s);
    case 8: return launch_band_n<8>(bands, out, taps, r, C, edges, textures, s);
    case 16: return launch_band_n<16>(bands, out, taps, r, C, edges, textures, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
