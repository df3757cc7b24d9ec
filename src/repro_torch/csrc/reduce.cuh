// Shared pieces of the hand-written Hopper kernels of repro_torch: launch
// geometry, the accumulator type, a compile-time dispatch over small widths,
// and the deterministic two-pass block reduction used by multidot and
// fused_body.
//
// The Pallas kernels accumulate their dot payload into one output block that
// a sequential TPU grid revisits.  On Hopper the blocks run in parallel in no
// order, so each block writes its partial sums to a (nblocks, m) scratch row
// and a second launch adds the rows in a fixed order.  No float atomics: the
// result repeats bit for bit from run to run.
#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;      // threads per block of every kernel
constexpr int kMaxBlocks = 1056;   // 8 resident blocks on each of 132 SMs
constexpr int kMaxWidth = 16;      // widest window a multidot/window_axpy takes
constexpr int kMaxDepth = 8;       // deepest pipeline l fused_body is built for

// Blocks of a grid-stride pass over n rows.
inline int reduce_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// Accumulator of a storage type: promote_types(T, float32).
template <typename T> struct AccOf;
template <> struct AccOf<float> { using type = float; };
template <> struct AccOf<double> { using type = double; };

// Calls f(std::integral_constant<int, v>) for Lo <= v <= Hi; false otherwise.
template <int Lo, int Hi, typename F>
inline bool dispatch_int(int v, F&& f) {
  if constexpr (Lo > Hi) {
    return false;
  } else {
    if (v == Lo) {
      f(std::integral_constant<int, Lo>{});
      return true;
    }
    return dispatch_int<Lo + 1, Hi>(v, std::forward<F>(f));
  }
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums each of vals[0..M) over the block (blockDim.x == kThreads) in a fixed
// order and writes the M block totals to out[0..M).
template <typename A, int M>
__device__ void block_sum_store(const A (&vals)[M], A* out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ A smem[M][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const A v = warp_sum(vals[k]);
    if (lane == 0) smem[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    A s = A(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[threadIdx.x][w];
    out[threadIdx.x] = s;
  }
}

// Second pass: out[k] = sum over b of partial[b * m + k], one block per k.
template <typename A>
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const A* __restrict__ partial, int nblocks, int m, A* __restrict__ out) {
  const int k = blockIdx.x;
  A s = A(0);
  for (int b = threadIdx.x; b < nblocks; b += kThreads) s += partial[static_cast<int64_t>(b) * m + k];
  const A vals[1] = {s};
  block_sum_store<A, 1>(vals, out + k);
}

template <typename A>
inline cudaError_t launch_sum_partials(const A* partial, int nblocks, int m, A* out,
                                       cudaStream_t stream) {
  sum_partials_kernel<A><<<m, kThreads, 0, stream>>>(partial, nblocks, m, out);
  return cudaGetLastError();
}

}  // namespace repro
