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
// What bounds them on an H100: the launch.  At 1080p a strip of n=2 is
// 1080 x 2 x 9 floats to gather and 1080 x 8 to scatter: their bytes take
// tens of nanoseconds, under the ~0.9 us an empty kernel takes on the card,
// and timed back to back they take 40-50 times their device time, in the
// host's wrapper and launch.  So a carve on the card runs them as nodes of
// the seam step's CUDA graph (ops/carve.py::SeamSteps, parallel/
// spatial.py): their geometry is static (the seam is read on the device,
// W is the buffer's width), and a replay launches them with no host work.
// A batch of 256 1-Mpix images moves ~4.7e6 floats a seam each way, a few
// microseconds of bandwidth.  band_energy costs 2*n^3 separately rounded
// multiplies and as many adds per output, like strip.cu.
//
// Design: one thread per output element, the flat index running along
// the band (or strip) row, so a warp's 32 lanes read neighbouring luma
// columns and write 128 contiguous bytes whatever the band's width.  Three
// 2-D layouts were measured against it (one row of threads a band row,
// blocks of (column, dy, row) threads, and rows whose strip starts are
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

#include <cuda_runtime.h>

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

template <int N>
__global__ void band_energy_kernel(const float* __restrict__ bands,
                                   float* __restrict__ out,
                                   const float* __restrict__ taps,
                                   size_t rows, int C, float edges,
                                   float textures) {
  __shared__ float s_taps[N * N];
  load_taps(taps, s_taps, N);
  const int cout = C - N + 1;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * cout) return;
  const size_t r = e / cout;
  const int p = static_cast<int>(e % cout);
  int roff[N];
  int cidx[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    roff[d] = d * C;
    cidx[d] = p + d;
  }
  out[e] = energy_chain<N>(bands + r * N * C, roff, cidx,
                           SharedTaps<N>{s_taps}, edges, textures);
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

// bands: (rows, n, C) f32; out: (rows, C-n+1) f32; taps: (n, n) f32.
// Returns the cudaError_t of the launch.
extern "C" int dc_band_energy(const float* bands, float* out,
                              const float* taps, long long rows, int n,
                              int C, float edges, float textures,
                              void* stream) {
  using namespace dct_carver;
  const size_t total = static_cast<size_t>(rows) * (C - n + 1);
  const dim3 block(256);
  const dim3 grid(static_cast<unsigned>((total + block.x - 1) / block.x));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t r = static_cast<size_t>(rows);
  switch (n) {
    case 2: band_energy_kernel<2><<<grid, block, 0, s>>>(bands, out, taps, r, C, edges, textures); break;
    case 4: band_energy_kernel<4><<<grid, block, 0, s>>>(bands, out, taps, r, C, edges, textures); break;
    case 8: band_energy_kernel<8><<<grid, block, 0, s>>>(bands, out, taps, r, C, edges, textures); break;
    case 16: band_energy_kernel<16><<<grid, block, 0, s>>>(bands, out, taps, r, C, edges, textures); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
