// Hand-written Hopper kernel for the (K4) sliding-window AXPY of p(l)-CG:
//   out[j] = (z[j] - sum_k V[j, k] g[k]) / gcc,  k < m,
// for a lane-major window V (n rows, row stride ldv >= m) and a strided z.
//
// Replaces the Pallas TPU kernel src/repro/kernels/window_axpy.py::window_axpy
// (_kernel).
//
// Bound on the H100: bytes.  It reads m*n + n words and writes n, with 2mn
// flops, so the floor is (m+2)*n*sizeof(T) / 3.35 TB/s.  Design: one row per
// thread in a grid-stride loop; the m+1 coefficients [g_0..g_{m-1}, gcc] are
// read from device memory (the scalar block wrote them there -- no host
// round trip) into registers once per thread.  The engine passes the column
// view Zw[:, l-1] as z; its stride is passed through instead of a copy.
#include "reduce.cuh"

namespace repro {

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    window_axpy_kernel(const T* __restrict__ V, int64_t ldv, const T* __restrict__ z, int64_t ldz,
                       const typename AccOf<T>::type* __restrict__ g, int64_t n,
                       T* __restrict__ out) {
  using A = typename AccOf<T>::type;
  A gr[M];
#pragma unroll
  for (int k = 0; k < M; ++k) gr[k] = g[k];
  const A gcc = g[M];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < n; j += stride) {
    const T* v = V + j * ldv;
    A s = A(0);
#pragma unroll
    for (int k = 0; k < M; ++k) s += static_cast<A>(v[k]) * gr[k];
    out[j] = static_cast<T>((static_cast<A>(z[j * ldz]) - s) / gcc);
  }
}

template <typename T>
int window_axpy(const void* V, int64_t ldv, const void* z, int64_t ldz, const void* g, int64_t n,
                int m, void* out, void* stream) {
  using A = typename AccOf<T>::type;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = reduce_blocks(n);
  const bool ok = dispatch_int<1, kMaxWidth>(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    window_axpy_kernel<T, M><<<nb, kThreads, 0, s>>>(
        static_cast<const T*>(V), ldv, static_cast<const T*>(z), ldz, static_cast<const A*>(g), n,
        static_cast<T*>(out));
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

int repro_window_axpy_f32(const void* V, int64_t ldv, const void* z, int64_t ldz, const void* g,
                          int64_t n, int m, void* out, void* stream) {
  return repro::window_axpy<float>(V, ldv, z, ldz, g, n, m, out, stream);
}

int repro_window_axpy_f64(const void* V, int64_t ldv, const void* z, int64_t ldz, const void* g,
                          int64_t n, int m, void* out, void* stream) {
  return repro::window_axpy<double>(V, ldv, z, ldz, g, n, m, out, stream);
}

}  // extern "C"
