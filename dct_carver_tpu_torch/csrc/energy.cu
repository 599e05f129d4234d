// Full DCT energy map of B planes: one thread per pixel.
//
// Replaces dct_carver_tpu/pallas/energy_kernel.py::_energy_pallas_batched
// (the pl.pallas_call at :170, kernel body _make_kernel :106 with the chain
// emitter _energy_chain_ops :65), reached through dct_energy_pallas.
//
// What bounds it on an H100: arithmetic.  A pixel costs 2*n^3 multiplies and
// as many adds (n^3 for the vertical chains, n^3 for the horizontal ones), so
// at n=16 a 4K frame is ~1.4e11 separately rounded float ops; the plane
// itself is only 33 MB.  Without fused multiply-add the float32 pipe runs at
// half its FMA rate.  A batch multiplies both by B: at n=8 a batch of 256
// 1-Mpix planes is ~2.7e11 ops, once per carve.
//
// Simple design: each thread recomputes its own n vertical chains per ky
// instead of sharing them with its row neighbours (n times the stage-1 work,
// but no shared-memory tiling); luma reads go through the read-only cache,
// where neighbouring threads hit the same lines.  The n*n taps sit in shared
// memory so that n=16 does not spend 256 registers on them.  The batch is
// the grid's z dimension; each plane's base offset is a size_t, since B * H
// * W passes INT_MAX near B = 1024 1-Mpix planes.

#include <cuda_runtime.h>

#include "energy_chain.cuh"

namespace dct_carver {

template <int N>
__global__ void energy_kernel(const float* __restrict__ luma,
                              float* __restrict__ out,
                              const float* __restrict__ taps, int H, int W,
                              int co, float edges, float textures) {
  __shared__ float s_taps[N * N];
  load_taps(taps, s_taps, N);
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= H || col >= W) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  out[plane + static_cast<size_t>(row) * W + col] =
      energy_at<N>(luma + plane, H, W, row, col, co, s_taps, edges, textures);
}

}  // namespace dct_carver

// luma, out: (B, H, W) f32 row-major; taps: (n, n) f32.  Returns the
// cudaError_t of the launch.
extern "C" int dc_energy(const float* luma, float* out, const float* taps,
                         int B, int H, int W, int n, int co, float edges,
                         float textures, void* stream) {
  using namespace dct_carver;
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y,
                  B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: energy_kernel<2><<<grid, block, 0, s>>>(luma, out, taps, H, W, co, edges, textures); break;
    case 4: energy_kernel<4><<<grid, block, 0, s>>>(luma, out, taps, H, W, co, edges, textures); break;
    case 8: energy_kernel<8><<<grid, block, 0, s>>>(luma, out, taps, H, W, co, edges, textures); break;
    case 16: energy_kernel<16><<<grid, block, 0, s>>>(luma, out, taps, H, W, co, edges, textures); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
