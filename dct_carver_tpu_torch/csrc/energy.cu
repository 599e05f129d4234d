// Full DCT energy map of B planes: a tiled stencil, one thread block per
// 16 x 64 tile of one plane.
//
// Replaces dct_carver_tpu/pallas/energy_kernel.py::_energy_pallas_batched
// (the pl.pallas_call at :170, kernel body _make_kernel :106 with the chain
// emitter _energy_chain_ops :65), reached through dct_energy_pallas.
//
// What bounds it on an H100: arithmetic.  No op may fuse (the chains round
// each multiply and add on its own), so each takes an issue slot of the
// float32 pipe: half its 67 TFLOP/s multiply-add rate.  A pixel needs n*n - 1
// atom chains of n multiplies and n - 1 adds, and its share of the vertical
// chains of its window columns (n per column, shared along the row): at n=8
// about 1.1e3 ops, so a 1080p frame is ~2.2e9 ops, a batch of 256 1-Mpix
// planes ~2.8e11; the plane itself is only 8 MB or 1 GB.
//
// Design: the block stages its tile's clamped luma window, (16 + n - 1) x
// (64 + n - 1), in shared memory once.  For each ky it computes the vertical
// chains V_ky of the tile's 16 rows and 64 + n - 1 window columns into
// shared memory (once a column, not once a pixel; two buffers, so one
// barrier a ky), then each thread reads the V values of its 4 adjacent
// pixels as float4s and runs their atom chains from registers, keeping each
// pixel's pick (energy_chain.cuh) in registers across the ky.  The taps are
// a kernel parameter (constant memory): every atom multiply takes its tap
// as an operand, so n = 16 spends no registers or loads on them.  Tiles
// run on the grid's x dimension and planes on z, with size_t plane offsets
// (B * H * W passes INT_MAX near B = 1024 1-Mpix planes), so no row count
// meets the grid's 65535 limit.

#include <climits>

#include <cuda_runtime.h>

#include "energy_chain.cuh"

namespace dct_carver {

template <int N>
struct EnergyTile {
  static constexpr int kThreads = 256;
  static constexpr int P = 4;                       // adjacent pixels a thread
  static constexpr int TW = 64;                     // tile columns
  static constexpr int TH = kThreads / (TW / P);    // tile rows (16)
  static constexpr int LW = TW + N - 1;             // window columns
  static constexpr int LH = TH + N - 1;             // window rows
  static constexpr int Q = (P + N - 1 + 3) / 4;     // float4s a thread reads
  static constexpr int VP = TW + (N < 4 ? 4 : N);   // V row pitch (>= 4Q + TW - P)
};

template <int N>
__global__ void __launch_bounds__(EnergyTile<N>::kThreads)
energy_kernel(const float* __restrict__ luma, float* __restrict__ out,
              const Taps<N> taps, int H, int W, int tiles_w, int co,
              float edges, float textures) {
  using T = EnergyTile<N>;
  __shared__ float L[T::LH * T::LW];
  __shared__ __align__(16) float V[2][T::TH * T::VP];
  const int tid = threadIdx.x;
  const int r0 = static_cast<int>(blockIdx.x / tiles_w) * T::TH;
  const int c0 = static_cast<int>(blockIdx.x % tiles_w) * T::TW;
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  const float* src = luma + plane;
  for (int e = tid; e < T::LH * T::LW; e += T::kThreads) {
    const int i = e / T::LW;
    const int c = e - i * T::LW;
    const int row = min(max(r0 + co + i, 0), H - 1);
    const int col = min(max(c0 + co + c, 0), W - 1);
    L[e] = __ldg(src + static_cast<size_t>(row) * W + col);
  }
  __syncthreads();

  const int ty = tid / (T::TW / T::P);
  const int x0 = (tid % (T::TW / T::P)) * T::P;
  Pick pick[T::P];
#pragma unroll 1
  for (int ky = 0; ky < N; ++ky) {
    float* Vk = V[ky & 1];
    float dy[N];
#pragma unroll
    for (int d = 0; d < N; ++d) dy[d] = taps(ky, d);
    const auto dy_taps = [&](int, int d) { return dy[d]; };
    for (int e = tid; e < T::TH * T::LW; e += T::kThreads) {
      const int i = e / T::LW;
      const int c = e - i * T::LW;
      const float* col = L + i * T::LW + c;
      Vk[i * T::VP + c] =
          chain<N>(dy_taps, ky, [&](int d) { return col[d * T::LW]; });
    }
    __syncthreads();  // V_ky complete; V_{ky-1}'s buffer is free for ky + 1

    float v[4 * T::Q];
    const float4* vr = reinterpret_cast<const float4*>(Vk + ty * T::VP + x0);
#pragma unroll
    for (int q = 0; q < T::Q; ++q) {
      const float4 f = vr[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int p = 0; p < T::P; ++p)
      pick_row<N>(pick[p], ky, [&](int kx) {
        return chain<N>(taps, kx, [&](int dx) { return v[p + dx]; });
      });
  }

  const int row = r0 + ty;
  if (row < H) {
    float* o = out + plane + static_cast<size_t>(row) * W + c0 + x0;
#pragma unroll
    for (int p = 0; p < T::P; ++p)
      if (c0 + x0 + p < W) o[p] = pick[p].energy<N>(edges, textures);
  }
}

template <int N>
int launch_energy(const float* luma, float* out, const float* taps_host,
                  int B, int H, int W, int co, float edges, float textures,
                  cudaStream_t s) {
  using T = EnergyTile<N>;
  Taps<N> taps;
  for (int i = 0; i < N * N; ++i) taps.d[i] = taps_host[i];
  const int tiles_w = (W + T::TW - 1) / T::TW;
  const long long tiles =
      static_cast<long long>(tiles_w) * ((H + T::TH - 1) / T::TH);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  energy_kernel<N><<<dim3(static_cast<unsigned>(tiles), 1, B), T::kThreads,
                     0, s>>>(luma, out, taps, H, W, tiles_w, co, edges,
                             textures);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dct_carver

// luma, out: (B, H, W) f32 row-major on the device; taps: (n, n) f32 in host
// memory (passed to the kernel by value).  Returns the cudaError_t of the
// launch.
extern "C" int dc_energy(const float* luma, float* out, const float* taps,
                         int B, int H, int W, int n, int co, float edges,
                         float textures, void* stream) {
  using namespace dct_carver;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch_energy<2>(luma, out, taps, B, H, W, co, edges, textures, s);
    case 4: return launch_energy<4>(luma, out, taps, B, H, W, co, edges, textures, s);
    case 8: return launch_energy<8>(luma, out, taps, B, H, W, co, edges, textures, s);
    case 16: return launch_energy<16>(luma, out, taps, B, H, W, co, edges, textures, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
