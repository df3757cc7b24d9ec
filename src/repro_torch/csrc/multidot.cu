// Hand-written Hopper kernel for the (K5) multi-dot of p(l)-CG:
//   out[k] = <W[:, k], z>,  k < m,
// for a lane-major window W (n rows, row stride ldw >= m) and a strided z.
//
// Replaces the Pallas TPU kernel src/repro/kernels/multidot.py::multidot
// (_kernel), which streams W and z through VMEM once and accumulates into a
// revisited output block.
//
// Bound on the H100: bytes.  It reads m*n + n words and does 2mn flops, far
// below the card's rate, so the floor is (m+1)*n*sizeof(T) / 3.35 TB/s.
// Design: one row per thread in a grid-stride loop, m accumulators in
// registers (m is a template parameter, so they never spill), then the
// deterministic two-pass reduction of reduce.cuh.  The engine hands in
// column views of the windows (Vw[:, :l+1], Zw[:, :l]); the row stride is
// passed through instead of copying them.
#include "reduce.cuh"

namespace repro {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    multidot_kernel(const T* __restrict__ W, int64_t ldw, const T* __restrict__ z, int64_t ldz,
                    int64_t n, typename AccOf<T>::type* __restrict__ partial) {
  using A = typename AccOf<T>::type;
  A acc[M];
#pragma unroll
  for (int k = 0; k < M; ++k) acc[k] = A(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < n; j += stride) {
    const A zj = static_cast<A>(z[j * ldz]);
    const T* w = W + j * ldw;
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] += static_cast<A>(w[k]) * zj;
  }
  block_sum_store<A, M>(acc, partial + static_cast<int64_t>(blockIdx.x) * M);
}

template <typename T>
int multidot(const void* W, int64_t ldw, const void* z, int64_t ldz, int64_t n, int m,
             void* partial, void* out, void* stream) {
  using A = typename AccOf<T>::type;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = reduce_blocks(n);
  A* part = static_cast<A*>(partial);
  const bool ok = dispatch_int<1, kMaxWidth>(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    multidot_kernel<T, M><<<nb, kThreads, 0, s>>>(static_cast<const T*>(W), ldw,
                                                   static_cast<const T*>(z), ldz, n, part);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum_partials<A>(part, nb, m, static_cast<A*>(out), s));
}

}  // namespace repro

extern "C" {

// Number of first-pass blocks (rows of the partial-sum scratch) for n rows.
int repro_reduce_blocks(int64_t n) { return repro::reduce_blocks(n); }

int repro_max_width() { return repro::kMaxWidth; }

int repro_max_depth() { return repro::kMaxDepth; }

int repro_multidot_f32(const void* W, int64_t ldw, const void* z, int64_t ldz, int64_t n, int m,
                       void* partial, void* out, void* stream) {
  return repro::multidot<float>(W, ldw, z, ldz, n, m, partial, out, stream);
}

int repro_multidot_f64(const void* W, int64_t ldw, const void* z, int64_t ldz, int64_t n, int m,
                       void* partial, void* out, void* stream) {
  return repro::multidot<double>(W, ldw, z, ldz, n, m, partial, out, stream);
}

}  // extern "C"
