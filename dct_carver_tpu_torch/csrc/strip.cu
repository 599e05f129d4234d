// Strip energy update after one seam removal from each of B images: one
// thread per (image, row, strip column), writing in place into the
// compacted energy.
//
// Replaces the packed strip pipeline of dct_carver_tpu/pallas/strip_kernel.py
// reached through strip_update_packed :828: the slab gather
// (_gather2_slabs_call, pl.pallas_call at :583), the chains on the slabs
// (_strip_energy2_call :715) and the read-modify-write scatter
// (_scatter2_strips_call :681).
//
// What bounds it on an H100: launch latency.  At 1080p and n=8 a strip is
// 1080 rows x 20 columns, ~2e4 pixels: a few microseconds of arithmetic,
// less than the cost of launching the kernel.  A batch of B images makes it
// arithmetic: 256 1-Mpix images at n=8 are ~5.2e6 strip pixels a seam, at
// 2*n^3 multiplies and as many adds each ~1.1e10 separately rounded ops,
// about 0.3 ms of the float32 pipe.
//
// Simple design: row i recomputes columns [start_i, start_i + strip_w) with
// start_i = clamp(seam_i - half, 0, W - strip_w) (ops/carve.py::
// _strip_bounds), reading the compacted, edge-filled luma directly with the
// same energy_at as the full map.  A per-row strip is exact because the
// seam moves at most delta_x columns a row; the TPU's block-shared slabs,
// 64-lane slot packing and pair groups exist for its vector layout and are
// not needed here.  Threads only read luma and each writes its own energy
// cell, so the update is race free in place.  The image is the grid's z
// dimension; its base offset is a size_t (B * H * W passes INT_MAX near
// B = 1024 1-Mpix images).
//
// Shard offset (the spatial route, parallel/spatial.py): the B images may
// be the column shards of one image, side by side on the card.  Shard b
// then owns global columns [lo + b*Wl, lo + (b+1)*Wl) of its energy plane,
// reads the seam every shard shares, and reads a luma plane with an
// edge-clamped halo of r-1 columns before and r after its own, so every
// window it needs lies in its plane.  Each shard computes the overlap of
// each row's strip with its own columns and writes only those; the strip
// start is clamped to the global width.  This replaces the R-block slabs of
// dct_carver_tpu/parallel/spatial.py::_sharded_strip_update_pallas.

#include <cuda_runtime.h>

#include "energy_chain.cuh"

namespace dct_carver {

template <int N>
__global__ void strip_kernel(const float* __restrict__ luma,
                             float* __restrict__ energy,
                             const int* __restrict__ seam,
                             const float* __restrict__ taps, int H, int W,
                             int Wx, int Wg, int lo, int lo_step, int xoff,
                             int seam_step, int co, int half, int strip_w,
                             float edges, float textures) {
  __shared__ float s_taps[N * N];
  load_taps(taps, s_taps, N);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= H || c >= strip_w) return;
  const int s = seam[static_cast<size_t>(blockIdx.z) * seam_step + row];
  const int start = min(max(s - half, 0), max(Wg - strip_w, 0));
  // the strip's global column, as a column of this image's energy plane
  const int col = start + c - (lo + static_cast<int>(blockIdx.z) * lo_step);
  if (col < 0 || col >= W) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H;
  energy[(plane + row) * W + col] =
      energy_at<N>(luma + plane * Wx, H, Wx, row, col + xoff, co, s_taps,
                   edges, textures);
}

}  // namespace dct_carver

// luma: (B, H, Wx) f32 and energy: (B, H, W) f32 row-major (energy updated
// in place); seam: int32, image b's at seam + b*seam_step; taps: (n, n) f32.
// Image b's energy column 0 is global column lo + b*lo_step and its luma
// column xoff; the strip start is clamped to the global width Wg.  One
// image: Wx = Wg = W, lo = lo_step = xoff = 0, seam_step = H.  Returns the
// cudaError_t of the launch.
extern "C" int dc_strip(const float* luma, float* energy, const int* seam,
                        const float* taps, int B, int H, int W, int Wx,
                        int Wg, int lo, int lo_step, int xoff, int seam_step,
                        int n, int co, int half, int strip_w, float edges,
                        float textures, void* stream) {
  using namespace dct_carver;
  const dim3 block(32, 8);
  const dim3 grid((strip_w + block.x - 1) / block.x,
                  (H + block.y - 1) / block.y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DC_STRIP(N)                                                         \
  strip_kernel<N><<<grid, block, 0, s>>>(luma, energy, seam, taps, H, W, Wx, \
                                         Wg, lo, lo_step, xoff, seam_step,  \
                                         co, half, strip_w, edges, textures)
  switch (n) {
    case 2: DC_STRIP(2); break;
    case 4: DC_STRIP(4); break;
    case 8: DC_STRIP(8); break;
    case 16: DC_STRIP(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DC_STRIP
  return static_cast<int>(cudaGetLastError());
}
