// Hand-written Hopper kernel for the (K1) SPMV of p(l)-CG on a local 2-D
// block: the unscaled 5-point Poisson stencil
//   y[r, c] = 4 x[r, c] - x[r-1, c] - x[r+1, c] - x[r, c-1] - x[r, c+1]
// on an (H, W) block, where the halo row halo_n (W,) stands in for row -1,
// halo_s (W,) for row H, and the halo columns halo_w / halo_e (H,) for
// columns -1 and W.  Accumulation in promote(T, float32); y is stored as T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil2d.py::stencil2d
// (_kernel), which tiles the block over row bands in VMEM and takes the
// vertical neighbours from the previous and next bands.
//
// Bound on the H100: bytes.  It reads x once and writes y once (2HW words;
// the halos add 2(H+W)) and does 5 flops a point, so the floor is
// 2HW sizeof(T) / 3.35 TB/s.  Design: one grid point per thread, threads of
// a warp on consecutive columns, so the loads of x and the store of y are
// coalesced along W when x is contiguous; the four neighbours come through
// L1/L2 (each x is read by five threads of neighbouring warps).  Row and
// column of a point are computed and masked, so H and W need not be powers
// of two and nothing wraps across a row.  x is read through its two
// strides: the engine passes the column Zw[:, 0] of a lane-major window
// viewed as (H, W), without a copy.
#include "reduce.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stencil2d_kernel(const T* __restrict__ x, int64_t sr, int64_t sc, const T* __restrict__ hn,
                     int64_t shn, const T* __restrict__ hs, int64_t shs,
                     const T* __restrict__ hw, int64_t shw, const T* __restrict__ he,
                     int64_t she, int64_t H, int64_t W, T* __restrict__ y) {
  using A = typename AccOf<T>::type;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= H * W) return;
  const int64_t r = j / W;
  const int64_t c = j - r * W;
  const T* xp = x + r * sr + c * sc;
  const A xc = static_cast<A>(xp[0]);
  const A up = static_cast<A>(r > 0 ? xp[-sr] : hn[c * shn]);
  const A down = static_cast<A>(r < H - 1 ? xp[sr] : hs[c * shs]);
  const A left = static_cast<A>(c > 0 ? xp[-sc] : hw[r * shw]);
  const A right = static_cast<A>(c < W - 1 ? xp[sc] : he[r * she]);
  y[j] = static_cast<T>(A(4) * xc - up - down - left - right);
}

template <typename T>
int stencil2d(const void* x, int64_t sr, int64_t sc, const void* hn, int64_t shn,
              const void* hs, int64_t shs, const void* hw, int64_t shw, const void* he,
              int64_t she, int64_t H, int64_t W, void* y, void* stream) {
  const int64_t n = H * W;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  stencil2d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), sr, sc, static_cast<const T*>(hn), shn,
      static_cast<const T*>(hs), shs, static_cast<const T*>(hw), shw,
      static_cast<const T*>(he), she, H, W, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// x (H, W) with row stride sr and column stride sc; halos with their own
// element strides; y (H, W) contiguous.
int repro_stencil2d_f32(const void* x, int64_t sr, int64_t sc, const void* hn, int64_t shn,
                        const void* hs, int64_t shs, const void* hw, int64_t shw,
                        const void* he, int64_t she, int64_t H, int64_t W, void* y,
                        void* stream) {
  return repro::stencil2d<float>(x, sr, sc, hn, shn, hs, shs, hw, shw, he, she, H, W, y,
                                 stream);
}

int repro_stencil2d_f64(const void* x, int64_t sr, int64_t sc, const void* hn, int64_t shn,
                        const void* hs, int64_t shs, const void* hw, int64_t shw,
                        const void* he, int64_t she, int64_t H, int64_t W, void* y,
                        void* stream) {
  return repro::stencil2d<double>(x, sr, sc, hn, shn, hs, shs, hw, shw, he, she, H, W, y,
                                  stream);
}

}  // extern "C"
