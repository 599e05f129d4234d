// Seam apply on a stack of column shards of one image: compact luma,
// origcol and energy around the removed seam in one pass, take the right
// neighbour's first column in at each shard's last column, edge-fill the
// luma from the new logical width on, and give each row's removed pixel's
// original column.  One thread per (shard, row, column).
//
// Replaces dct_carver_tpu/pallas/spatial_dp_kernel.py::sharded_apply_rows
// (the pl.pallas_call at :348, kernel _make_sharded_apply_kernel :288),
// reached through parallel/spatial.py::_spatial_seam_step's fused apply.
//
// What bounds it on an H100: memory traffic.  Three (S, H, Wl) 4-byte
// planes are read once and written once, 24 bytes a pixel: 796 MB a seam
// for an 8K panorama (4320 x 7680), about 0.24 ms at the card's 3.35 TB/s.
//
// Simple design, as csrc/apply.cu (rows by grid stride, so any height
// runs): it reads one set of state buffers and
// writes a second (the carve swaps them every seam), because compacting in
// place across parallel blocks would race.  Column j of shard s takes input
// column j before the seam and j+1 from the seam on; the last column takes
// the incoming column instead, which the exchange layer brought from shard
// s+1 (luma, energy and the origcol's bits as a float).  The seam and the
// edge value are one per row, shared by the shards; the new logical width
// is read from device memory.  Thread 0 of each row writes that shard's
// part of the removed pixel's original column (0 where the seam lies on
// another shard), which the caller sums over the shards, as the TPU
// kernel's one-hot side output.

#include <algorithm>

#include <cuda_runtime.h>

namespace dct_carver {

__global__ void sharded_apply_kernel(
    const float* __restrict__ luma, const int* __restrict__ origcol,
    const float* __restrict__ energy, const int* __restrict__ seam,
    const float* __restrict__ edge, const float* __restrict__ incoming,
    float* __restrict__ luma_out, int* __restrict__ origcol_out,
    float* __restrict__ energy_out, int* __restrict__ orig, int H, int Wl,
    int lo, const int* __restrict__ new_width) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Wl) return;
  const int lo_s = lo + static_cast<int>(blockIdx.z) * Wl;
  for (int row = blockIdx.y; row < H; row += gridDim.y) {
    const size_t r = static_cast<size_t>(blockIdx.z) * H + row;
    const size_t base = r * Wl;
    const int s = seam[row];
    float l, e;
    int o;
    if (lo_s + j < s) {
      l = luma[base + j];
      e = energy[base + j];
      o = origcol[base + j];
    } else if (j == Wl - 1) {
      const float* in = incoming + r * 3;
      l = in[0];
      e = in[1];
      o = __float_as_int(in[2]);
    } else {
      l = luma[base + j + 1];
      e = energy[base + j + 1];
      o = origcol[base + j + 1];
    }
    luma_out[base + j] = lo_s + j >= *new_width ? edge[row] : l;
    energy_out[base + j] = e;
    origcol_out[base + j] = o;
    if (j == 0) {
      const int li = s - lo_s;
      orig[r] = (li >= 0 && li < Wl) ? origcol[base + li] : 0;
    }
  }
}

}  // namespace dct_carver

// luma, origcol, energy and the three outputs: (S, H, Wl) row-major;
// seam, edge: (H,); incoming: (S, H, 3) f32; orig: (S, H) int32 out;
// new_width: one int32 on the device, the logical width after the removal;
// S <= 65535 (grid z).  Returns the cudaError_t of the launch.
extern "C" int dc_sharded_apply(const float* luma, const int* origcol,
                                const float* energy, const int* seam,
                                const float* edge, const float* incoming,
                                float* luma_out, int* origcol_out,
                                float* energy_out, int* orig, int S, int H,
                                int Wl, int lo, const int* new_width,
                                void* stream) {
  const dim3 block(256);
  // rows by grid stride: y is capped at 65535
  const dim3 grid((Wl + block.x - 1) / block.x, std::min(H, 65535), S);
  dct_carver::sharded_apply_kernel<<<grid, block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      luma, origcol, energy, seam, edge, incoming, luma_out, origcol_out,
      energy_out, orig, H, Wl, lo, new_width);
  return static_cast<int>(cudaGetLastError());
}
