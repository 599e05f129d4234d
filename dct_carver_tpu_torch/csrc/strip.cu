// Strip energy update after one seam removal from each of B images: each
// thread block takes R strip rows of the B*H rows, and each row a team of
// strip_w * n threads, one (pixel, ky) pair each; writes in place into the
// compacted energy.
//
// Replaces the packed strip pipeline of dct_carver_tpu/pallas/strip_kernel.py
// reached through strip_update_packed :828: the slab gather
// (_gather2_slabs_call, pl.pallas_call at :583), the chains on the slabs
// (_strip_energy2_call :715) and the read-modify-write scatter
// (_scatter2_strips_call :681).
//
// What bounds it on an H100: launch latency for one image, arithmetic for a
// batch.  At 1080p and n=8 a strip is 1080 rows x 20 columns, ~2e4 pixels:
// a few microseconds of arithmetic, less than a launch.  256 1-Mpix images
// at n=8 are 2.6e5 strip rows a seam; a row needs the vertical chains of its
// 27 window columns and 63 atom chains of each of its 20 pixels, ~2.2e4
// separately rounded ops, so ~5.8e9 ops a seam, ~0.17 ms at the float32
// pipe's unfused rate.
//
// Design: row i recomputes columns [start_i, start_i + strip_w) with start_i
// = clamp(seam_i - half, 0, W - strip_w) (ops/carve.py::_strip_bounds), from
// the compacted, edge-filled luma.  A per-row strip is exact because the
// seam moves at most delta_x columns a row; the TPU's block-shared slabs,
// 64-lane slot packing and pair groups exist for its vector layout and are
// not needed here.  The block stages each row's clamped luma band, n x
// (strip_w + n - 1), in shared memory, computes the band's n x (strip_w +
// n - 1) vertical chains once into shared memory, and then each thread runs
// the n atom chains of its (pixel, ky) pair from registers (taps as kernel
// parameters, energy_chain.cuh).  A pixel's n picks sit on n adjacent lanes
// of one warp and are combined by shuffles (the pick is order-independent,
// so the bits stay those of the sequential loop).  At n=8 a row is 160
// threads, with no idle lane; rows wider than 1024 threads (a wide delta_x)
// loop their pairs.  Threads only read luma and each pixel's energy cell is
// written by one thread, so the update is race free in place.  An image's
// rows run on the grid's x dimension, so no row count meets the grid's
// 65535 limit, and the images on y (B <= 65535), with size_t plane offsets
// (B * H * W passes INT_MAX near B = 1024 1-Mpix images).
//
// Shard offset (the spatial route, parallel/spatial.py): the B images may
// be the column shards of one image, side by side on the card.  Shard b
// then owns global columns [lo + b*Wl, lo + (b+1)*Wl) of its energy plane,
// reads the seam every shard shares, and reads a luma plane with an
// edge-clamped halo of r-1 columns before and r after its own, so every
// window it needs lies in its plane.  Each shard computes the overlap of
// each row's strip with its own columns and writes only those (a row whose
// strip misses its columns is skipped); the strip start is clamped to the
// global width.  This replaces the R-block slabs of
// dct_carver_tpu/parallel/spatial.py::_sharded_strip_update_pallas.

#include <algorithm>

#include <cuda_runtime.h>

#include "dp_rows.cuh"
#include "energy_chain.cuh"

namespace dct_carver {

// One launch's shape: R rows a block, a team of `team` threads a row, the V
// row pitch `vp`, and the dynamic shared memory.
struct StripShape {
  int R, team, threads, vp;
  size_t smem;
};

inline StripShape strip_shape(int n, int strip_w) {
  StripShape s;
  s.team = std::min(strip_w * n, kMaxThreads);  // both multiples of n
  s.R = std::max(1, 512 / s.team);
  s.threads = (s.R * s.team + 31) / 32 * 32;
  // a warp's lanes (c, ky) read V[ky][c + dx]: a pitch of 32/n mod 32 puts
  // the n rows of one row's V on distinct banks
  const int bw = strip_w + n - 1;
  s.vp = bw + ((32 / n - bw % 32) % 32 + 32) % 32;
  s.smem = (static_cast<size_t>(s.R) * n * (bw + s.vp) + n * (n + 1))
           * sizeof(float);
  return s;
}

template <int N>
__global__ void strip_kernel(const float* __restrict__ luma,
                             float* __restrict__ energy,
                             const int* __restrict__ seam, const Taps<N> taps,
                             int H, int W, int Wx, int Wg,
                             int lo, int lo_step, int xoff, int seam_step,
                             int co, int half, int strip_w, int R, int team,
                             int vp, float edges, float textures) {
  extern __shared__ __align__(16) float sm[];
  const int bw = strip_w + N - 1;  // band columns
  const int tid = threadIdx.x;
  // the taps, rows padded to N + 1 so that lanes of different ky read
  // distinct banks
  float* s_taps = sm + R * N * (bw + vp);
  for (int e = tid; e < N * N; e += blockDim.x)
    s_taps[(e / N) * (N + 1) + e % N] = taps.d[e];

  // this thread's row r of the block: row i of image b
  int r = 0, lane = tid;
  while (lane >= team) {  // r = tid / team, R is small
    lane -= team;
    ++r;
  }
  const int b = blockIdx.y;
  const int i = blockIdx.x * R + r;
  const int x0 = lo + b * lo_step;  // the global column of energy column 0
  int start = 0;
  bool live = r < R && i < H;
  if (live) {
    start = min(max(seam[static_cast<size_t>(b) * seam_step + i] - half, 0),
                max(Wg - strip_w, 0));
    // a shard computes only the rows whose strip meets its columns
    live = start < x0 + W && start + strip_w > x0;
  }
  float* band = sm + r * N * bw;            // N x bw
  float* V = sm + R * N * bw + r * N * vp;  // N x vp

  // the band: the row's (column c, window row k) pairs q = c*N + k take
  // band columns c and, for c < N - 1, strip_w + c; band column t is global
  // column start + co + t
  if (live) {
    const int base = start + co - x0 + xoff;  // band column 0 in luma
    for (int q = lane; q < strip_w * N; q += team) {
      const int c = q / N;
      const int k = q % N;
      const float* src =
          luma + (static_cast<size_t>(b) * H + min(max(i + co + k, 0), H - 1))
                     * Wx;
      band[k * bw + c] = __ldg(src + min(max(base + c, 0), Wx - 1));
      if (c < N - 1)
        band[k * bw + strip_w + c] =
            __ldg(src + min(max(base + strip_w + c, 0), Wx - 1));
    }
  }
  __syncthreads();

  // the vertical chains of every band column, once: V[k][c] and, for
  // c < N - 1, V[k][strip_w + c]
  const auto tap = [&](int k, int j) { return s_taps[k * (N + 1) + j]; };
  if (live) {
    for (int q = lane; q < strip_w * N; q += team) {
      const int c = q / N;
      const int k = q % N;
      V[k * vp + c] = chain<N>(tap, k, [&](int dy) { return band[dy * bw + c]; });
      if (c < N - 1)
        V[k * vp + strip_w + c] = chain<N>(
            tap, k, [&](int dy) { return band[dy * bw + strip_w + c]; });
    }
  }
  __syncthreads();

  // the atom chains of pair (c, ky), then the pixel's N picks, on N
  // aligned lanes of one warp, combined by shuffles
  for (int q0 = 0; q0 < strip_w * N; q0 += team) {
    const int q = q0 + lane;
    const int c = q / N;
    const int ky = q % N;
    const bool mine = live && q < strip_w * N;
    Pick p;
    if (mine) {
      const float* vr = V + ky * vp + c;
      float v[N];
#pragma unroll
      for (int dx = 0; dx < N; ++dx) v[dx] = vr[dx];
      pick_row<N>(p, ky, [&](int kx) {
        return chain<N>(taps, kx, [&](int dx) { return v[dx]; });
      });
    }
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, p.v, off);
      const int orank = __shfl_xor_sync(0xffffffffu, p.rank, off);
      p.add(ov, orank);
    }
    // the strip's global column, as a column of this image's energy plane
    const int col = start + c - x0;
    if (mine && ky == 0 && col >= 0 && col < W)
      energy[(static_cast<size_t>(b) * H + i) * W + col] =
          p.energy<N>(edges, textures);
  }
}

template <int N>
int launch_strip(const float* luma, float* energy, const int* seam,
                 const float* taps_host, int B, int H, int W, int Wx, int Wg,
                 int lo, int lo_step, int xoff, int seam_step, int co,
                 int half, int strip_w, float edges, float textures,
                 cudaStream_t stream) {
  Taps<N> taps;
  for (int i = 0; i < N * N; ++i) taps.d[i] = taps_host[i];
  const StripShape s = strip_shape(N, strip_w);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = allow_smem(strip_kernel<N>, s.smem)) return err;
  const dim3 grid((H + s.R - 1) / s.R, B);
  strip_kernel<N><<<grid, s.threads, s.smem, stream>>>(
      luma, energy, seam, taps, H, W, Wx, Wg, lo, lo_step, xoff, seam_step,
      co, half, strip_w, s.R, s.team, s.vp, edges, textures);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct_carver

// luma: (B, H, Wx) f32 and energy: (B, H, W) f32 row-major on the device
// (energy updated in place); seam: int32, image b's at seam + b*seam_step;
// taps: (n, n) f32 in host memory (passed to the kernel by value).  Image
// b's energy column 0 is global column lo + b*lo_step and its luma column
// xoff; the strip start is clamped to the global width Wg.  One image:
// Wx = Wg = W, lo = lo_step = xoff = 0, seam_step = H.  B <= 65535.
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int dc_strip(const float* luma, float* energy, const int* seam,
                        const float* taps, int B, int H, int W, int Wx,
                        int Wg, int lo, int lo_step, int xoff, int seam_step,
                        int n, int co, int half, int strip_w, float edges,
                        float textures, void* stream) {
  using namespace dct_carver;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DC_STRIP(N)                                                         \
  launch_strip<N>(luma, energy, seam, taps, B, H, W, Wx, Wg, lo, lo_step,   \
                  xoff, seam_step, co, half, strip_w, edges, textures, s)
  switch (n) {
    case 2: return DC_STRIP(2);
    case 4: return DC_STRIP(4);
    case 8: return DC_STRIP(8);
    case 16: return DC_STRIP(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DC_STRIP
}
