// Seam apply: compact luma, origcol and energy of B images around each
// image's removed seam in one pass, and edge-fill the luma from the new
// logical width on.  One thread per (image, row, column).
//
// Replaces dct_carver_tpu/pallas/apply_kernel.py::_apply_seam_batched (the
// pl.pallas_call at :105, kernel body _make_apply_kernel :69), reached
// through apply_seam_pallas, together with its small gather
// new_edge_value :57.
//
// What bounds it on an H100: memory traffic.  Three (H, W) 4-byte planes
// are read once and written once, 6 * 4 * H * W bytes: 50 MB a seam at
// 1080p, about 15 us at the card's 3.35 TB/s; for a batch B times that, 6.4
// GB a seam (about 1.9 ms) for 256 1-Mpix images.
//
// Simple design: the kernel reads one set of state buffers and writes a
// second set (the caller swaps the two every seam), because compacting in
// place across parallel blocks would race.  Column j takes input column j
// before the seam and j+1 from the seam on; column W-1 wraps to column 0, as
// jnp.roll does (that column lies in the dead region).  The edge value is
// read here from the old luma at seam == width-1 ? width-2 : width-1.  The
// image is the grid's z dimension; rows walk the grid's y dimension by
// stride (y is capped at 65535, so any height runs); offsets are size_t,
// since B * H * W passes INT_MAX near B = 1024 1-Mpix images.  Every image
// shares the logical width: each loses one seam a step.  The width comes
// by value, or from device memory (one int an image, as sharded_apply.cu
// reads new_width), so a carve's seam step can keep it on the device and
// run as a CUDA graph whose replays all read the current width.

#include <algorithm>

#include <cuda_runtime.h>

namespace dct_carver {

__global__ void apply_kernel(const float* __restrict__ luma,
                             const int* __restrict__ origcol,
                             const float* __restrict__ energy,
                             const int* __restrict__ seam,
                             float* __restrict__ luma_out,
                             int* __restrict__ origcol_out,
                             float* __restrict__ energy_out, int H, int W,
                             int width0, const int* __restrict__ widths) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int width = widths ? widths[blockIdx.z] : width0;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const size_t row = static_cast<size_t>(blockIdx.z) * H + y;
    const size_t base = row * W;
    const int s = seam[row];
    const int src = j < s ? j : (j + 1 == W ? 0 : j + 1);
    if (j >= width - 1) {
      const int edge = s == width - 1 ? width - 2 : width - 1;
      luma_out[base + j] = luma[base + edge];
    } else {
      luma_out[base + j] = luma[base + src];
    }
    origcol_out[base + j] = origcol[base + src];
    energy_out[base + j] = energy[base + src];
  }
}

}  // namespace dct_carver

// All planes (B, H, W) row-major: luma/energy f32, origcol int32; seam
// (B, H) int32; the logical width before the removal is widths[b] (an
// int32 array on the device), or width for every image where widths is
// null; B <= 65535 (grid z).  Returns the cudaError_t of the launch.
extern "C" int dc_apply(const float* luma, const int* origcol,
                        const float* energy, const int* seam, float* luma_out,
                        int* origcol_out, float* energy_out, int B, int H,
                        int W, int width, const int* widths, void* stream) {
  const dim3 block(256);
  // rows by grid stride: y is capped at 65535
  const dim3 grid((W + block.x - 1) / block.x, std::min(H, 65535), B);
  dct_carver::apply_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, origcol, energy, seam, luma_out, origcol_out, energy_out, H, W,
      width, widths);
  return static_cast<int>(cudaGetLastError());
}
