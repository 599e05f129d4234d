// The row loop shared by the seam DP kernel (find_seam.cu) and the spatial
// block DP (spatial_dp.cu): rows 1..N of the min-plus recurrence over one
// row of W columns, one CTA.
//
// Compute: thread t owns the C contiguous columns [t*C, t*C + C).  Its part
// of the frontier lives in registers; the only values it needs from other
// threads are its neighbours' edge cells, which every thread publishes in a
// double-buffered edge array in shared memory, so one barrier a row
// suffices.
//
// Memory: input rows are staged with cp.async into a ring of kStages rows
// in shared memory, kStages - 1 rows ahead of the row being computed, so the
// row's critical path holds no load from L2 or HBM.  The copies are
// coalesced: thread t moves the 4-column groups t, t + T, ... of a row, and
// the barrier of each row makes them visible to the thread whose chunk
// holds them.  With 4-column chunks (up to 4096 columns) a thread's group
// is its own chunk, and it stores its row's outputs (M, or packed parents)
// straight from registers, coalesced.  Wider chunks write them back over
// their inputs in the ring slot; one row later, the thread that copied each
// group in copies that group's outputs out to device memory and stages the
// row kStages ahead in its place, so no thread ever touches a group that
// another thread has in flight.  Chunks sit kPitch floats apart in a slot,
// which keeps a warp's 16-byte shared-memory accesses free of bank
// conflicts.
//
// Op order as ops/dp.py: m = e + min(min(left, centre), right), each op
// rounded on its own; cells outside the window are +inf, and so are left of
// column 0 and right of column W-1.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace dct_carver {

// Per chunk width C: the ring's depth and a chunk's pitch in a ring slot,
// chosen so that the ring and the edges fit one block's 227 KB at the
// largest width each C serves (1024*C columns); the widest rows get a ring
// of one slot and two barriers a row.  A CTA has at most 1024 threads.
// On an NVIDIA H100 80GB HBM3 the row time grows with C at a fixed width:
// the narrowest chunk, and so the most warps, wins.
template <int C>
struct Chunk {
  static_assert(C == 4 || C == 8 || C == 16 || C == 32, "C");
  static constexpr int kStages = C == 4 ? 8 : (C == 8 ? 4 : (C == 16 ? 2 : 1));
  static constexpr int kPitch = C == 4 ? 4 : C + 4;
};
constexpr int kMaxThreads = 1024;

// The chunk width for a row of W columns: the narrowest chunk that keeps the
// CTA within kMaxThreads.  Covers W <= 32768.
inline int chunk_for(int W) {
  if (W <= kMaxThreads * 4) return 4;
  if (W <= kMaxThreads * 8) return 8;
  if (W <= kMaxThreads * 16) return 16;
  return 32;
}

// go(std::integral_constant<int, C>{}) with C = chunk_for(W).
template <class Go>
int with_chunk(int W, Go go) {
  switch (chunk_for(W)) {
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    default: return go(std::integral_constant<int, 32>{});
  }
}

template <int C>
inline int threads_for(int W) {
  return (((W + C - 1) / C + 31) / 32) * 32;
}

// Dynamic shared memory of dp_rows: the ring, then the edge array
// (2 buffers x {first, last} x T floats).
template <int C>
inline size_t ring_bytes(int threads) {
  return (static_cast<size_t>(Chunk<C>::kStages) * threads * Chunk<C>::kPitch
          + 4 * static_cast<size_t>(threads)) * sizeof(float);
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` pass the
// 48 KB default; the cudaError_t of the call, or 0.
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The parent direction as an int8 bit pattern (-1 = 0xff): the tie-most
// minimum of (left, centre, right), given mn, their minimum; the rule of
// dct_carver_tpu/pallas/dp_kernel.py::_parent_select (left <= centre ?
// (left <= right ? -1 : 1) : (centre <= right ? 0 : 1) for the leftmost
// tie, mirrored for the rightmost), which for non-NaN values is the first
// of the tie side's candidates equal to mn.
template <bool RIGHTMOST>
__device__ __forceinline__ uint32_t parent_byte(float left, float centre,
                                                float right, float mn) {
  if (RIGHTMOST) return right == mn ? 1u : (centre == mn ? 0u : 0xffu);
  return left == mn ? 0xffu : (centre == mn ? 0u : 1u);
}

// A thread's live columns [a, b) within its chunk: the DP's column window
// met with the row, in chunk coordinates.
struct Window {
  int a, b;
  __device__ Window(int lo, int hi, int j0, int C)
      : a(min(max(lo - j0, 0), C)), b(min(max(hi - j0, 0), C)) {}
  __device__ __forceinline__ bool has(int i) const { return i >= a && i < b; }
};

// One row over a chunk: m holds the chunk's previous row and gets the new
// one; e is the chunk's staged input row (16-byte aligned); left/right the
// previous row's cells beside the chunk.  v[g] gets the outputs of columns
// 4g .. 4g+3: M as a float4, or with PARENTS one 32-bit word of packed
// parent bytes, lowest byte first.  MASKED applies `win`.
template <int C, bool PARENTS, bool RIGHTMOST, bool MASKED, class Out>
__device__ __forceinline__ void chunk_row(float (&m)[C], const float* e,
                                          const Window& win, float left,
                                          float right, Out (&v)[C / 4]) {
  const float4* e4 = reinterpret_cast<const float4*>(e);
  float l = left;  // the previous row's cell left of column i
#pragma unroll
  for (int g = 0; g < C / 4; ++g) {
    const float4 in = e4[g];
    const float ev[4] = {in.x, in.y, in.z, in.w};
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * g + q;
      const float c = m[i];
      const float r = i + 1 < C ? m[i + 1] : right;
      const float mn = fminf(fminf(l, c), r);
      m[i] = __fadd_rn(MASKED && !win.has(i) ? INFINITY : ev[q], mn);
      if (PARENTS) word |= parent_byte<RIGHTMOST>(l, c, r, mn) << (8 * q);
      l = c;
    }
    if constexpr (PARENTS)
      v[g] = word;
    else
      v[g] = make_float4(m[4 * g], m[4 * g + 1], m[4 * g + 2], m[4 * g + 3]);
  }
}

// Rows 1..N of the recurrence.  m holds the thread's chunk of row 0 (cells
// outside `win` already +inf) and gets row N's.  Io moves the rows:
//   io.load(k, dst, c):   cp.async columns [c, c+4) of input row k (those
//                         < W) to dst, 16-byte aligned shared memory;
//   io.store(k, v, c):    write row k's outputs of those columns: v is a
//                         float4 of M, or (PARENTS) a 32-bit word packing
//                         their int8 parent directions, lowest byte first.
// Thread t moves groups t + n*T, n < C/4, of every row: ceil(W/4) <= T*C/4;
// with C = 4 that group is its own chunk, whose outputs it stores at once.
template <int C, bool PARENTS, bool RIGHTMOST, class Io>
__device__ __forceinline__ void dp_rows(const Io& io, float (&m)[C], int N,
                                        int W, const Window& win,
                                        unsigned char* smem) {
  using Out = std::conditional_t<PARENTS, uint32_t, float4>;
  constexpr int D = Chunk<C>::kStages;
  constexpr int P = Chunk<C>::kPitch;
  constexpr int G = C / 4;
  const float inf = INFINITY;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  float* ring = reinterpret_cast<float*>(smem);
  float* edges = ring + D * T * P;
  const int groups = (W + 3) / 4;
  // group t + n*T sits at off0 + n*step of a slot (4T is a multiple of C)
  const int off0 = (4 * t / C) * P + (4 * t) % C;
  const int step = (4 * T / C) * P;
  const bool full = win.a == 0 && win.b == C;

  // this thread's outputs of the row in slot `so`
  auto take = [&](int so, Out (&v)[G]) {
#pragma unroll
    for (int n = 0; n < G; ++n)
      if (t + n * T < groups)
        v[n] = *reinterpret_cast<const Out*>(ring + so + off0 + n * step);
  };
  // write row k_out's outputs v, and stage row k_in in their slot `so`
  auto turn = [&](int k_out, const Out (&v)[G], int k_in, int so) {
#pragma unroll
    for (int n = 0; n < G; ++n) {
      const int g = t + n * T;
      if (g < groups) {
        if (k_out >= 1) io.store(k_out, v[n], 4 * g);
        if (k_in <= N) io.load(k_in, ring + so + off0 + n * step, 4 * g);
      }
    }
    cp_async_commit();
  };

  Out v[G];  // outputs of the row before, on their way out
  for (int k = 1; k <= (D > 1 ? D - 1 : 1); ++k) turn(0, v, k, (k % D) * T * P);
  edges[t] = m[0];
  edges[T + t] = m[C - 1];
  cp_async_wait<(D > 1 ? D - 2 : 0)>();  // row 1 has landed
  __syncthreads();

  int par = 0;  // the edge buffer holding the previous row's edges
  for (int k = 1; k <= N; ++k) {
    const float* eb = edges + 2 * par * T;
    const float left = t > 0 ? eb[T + t - 1] : inf;
    const float right = t + 1 < T ? eb[t + 1] : inf;
    const int so = ((k - 1) % D) * T * P;  // row k - 1's slot
    if constexpr (C > 4 && D > 1) {
      if (k > 1) take(so, v);
    }
    float* e = ring + (k % D) * T * P + t * P;
    Out o[G];
    if (full)
      chunk_row<C, PARENTS, RIGHTMOST, false>(m, e, win, left, right, o);
    else
      chunk_row<C, PARENTS, RIGHTMOST, true>(m, e, win, left, right, o);
    if constexpr (C == 4) {
      // the chunk is the thread's own group: out directly, coalesced
      if (t < groups) io.store(k, o[0], 4 * t);
    } else {
      // over the inputs; a row later the group's copier takes it out
#pragma unroll
      for (int g = 0; g < G; ++g) *reinterpret_cast<Out*>(e + 4 * g) = o[g];
    }
    float* nb = edges + 2 * (par ^ 1) * T;
    nb[t] = m[0];
    nb[T + t] = m[C - 1];
    par ^= 1;
    if constexpr (D > 1) {
      turn(C == 4 ? 0 : k - 1, v, k - 1 + D, so);
      cp_async_wait<(D > 1 ? D - 2 : 0)>();  // row k + 1 has landed
      __syncthreads();
    } else {  // one slot: out with row k, in with row k + 1
      __syncthreads();
      take(0, v);
      turn(k, v, k + 1, 0);
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  if constexpr (C > 4 && D > 1) {
    if (N >= 1) {
      take((N % D) * T * P, v);
      turn(N, v, N + 1, (N % D) * T * P);
    }
  }
  cp_async_wait<0>();
}

}  // namespace dct_carver
