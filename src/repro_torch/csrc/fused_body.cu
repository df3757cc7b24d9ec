// Hand-written Hopper kernel for the fused p(l)-CG iteration body: in ONE
// pass over the lane-major windows Vw (n, 2l+1) and Zw (n, l+1) it computes
//   (K1) t = A z_0, the zero-Dirichlet 5-point stencil on the (H, W) grid of
//        Zw[:, 0], rounded to the storage type -- or reads a streamed t;
//   (K4) v_new = (z_{l-1} - sum_k g_k V[:, k]) / gcc   (steady bodies only)
//        z_new = (t - gam z_0 - dsub z_1) / dlt        (steady)
//              =  t - s_warm z_0                      (warmup)
//        and writes the shifted windows Vw2, Zw2;
//   (K5) the 2l+1 payload dots [<Vw2[:, k], z_new>]_{k<=l}, [<Zw2[:, k], z_new>]_{k<l}
//        against the updated windows as stored.
// The scalars arrive packed in one device vector
//   scal = [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0 .. g_{2l-1}]
// written by the engine's scalar block; nothing is read back to the host.
//
// Replaces the Pallas TPU megakernel src/repro/kernels/fused_body.py::fused_body
// (_make_kernel), without its zhat window and in-body diagonal preconditioner.
//
// Bound on the H100: bytes.  Each body reads Vw and Zw once and writes Vw2 and
// Zw2 once: 2 (3l+2) n words (one more n with a streamed t), about 50 flops a
// row.  Design:
//  * one grid row per thread in a grid-stride loop; the row's 3l+2 window
//    entries and the 2l+1 dot accumulators live in registers (l is a template
//    parameter);
//  * the stencil reads the four neighbours of Zw[j, 0] directly from the
//    input window; neighbours of the flattened (H, W) grid are zero across
//    the grid's edges (row r = j / W, column c = j % W are masked, so j +- 1
//    never wraps into the next grid row and H need not be a power of two);
//  * because other blocks read Zw[:, 0] as stencil neighbours while this
//    block writes, the outputs go to separate buffers (the engine ping-pongs
//    two window pairs) -- the input windows are never written;
//  * the dot payload is reduced with the deterministic two-pass reduction of
//    reduce.cuh (no float atomics).
#include "reduce.cuh"

namespace repro {

constexpr int kFixedScalars = 7;  // steady, s_warm, gam, dlt, dsub, gcc, invd

template <typename T, int L, bool STENCIL>
__global__ void __launch_bounds__(kThreads)
    fused_body_kernel(const T* __restrict__ Vw, const T* __restrict__ Zw,
                      const typename AccOf<T>::type* __restrict__ scal, const T* __restrict__ t,
                      int64_t n, int64_t H, int64_t Wd, T* __restrict__ Vo, T* __restrict__ Zo,
                      typename AccOf<T>::type* __restrict__ partial) {
  using A = typename AccOf<T>::type;
  constexpr int MV = 2 * L + 1;
  constexpr int MZ = L + 1;
  const bool steady = scal[0] > A(0.5);
  const A s_warm = scal[1], gam = scal[2], dlt = scal[3], dsub = scal[4], gcc = scal[5];
  A g[2 * L];
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) g[k] = scal[kFixedScalars + k];
  A d[MV];
#pragma unroll
  for (int k = 0; k < MV; ++k) d[k] = A(0);

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < n; j += stride) {
    A V[MV], Z[MZ];
    const T* vr = Vw + j * MV;
    const T* zr = Zw + j * MZ;
#pragma unroll
    for (int k = 0; k < MV; ++k) V[k] = static_cast<A>(vr[k]);
#pragma unroll
    for (int k = 0; k < MZ; ++k) Z[k] = static_cast<A>(zr[k]);

    A tj;
    if constexpr (STENCIL) {
      const int64_t r = j / Wd;
      const int64_t c = j - r * Wd;
      const A up = r > 0 ? static_cast<A>(Zw[(j - Wd) * MZ]) : A(0);
      const A down = r < H - 1 ? static_cast<A>(Zw[(j + Wd) * MZ]) : A(0);
      const A left = c > 0 ? static_cast<A>(Zw[(j - 1) * MZ]) : A(0);
      const A right = c < Wd - 1 ? static_cast<A>(Zw[(j + 1) * MZ]) : A(0);
      tj = static_cast<A>(static_cast<T>(A(4) * Z[0] - up - down - left - right));
    } else {
      tj = static_cast<A>(t[j]);
    }

    A znew;
    if (steady) {
      A s = A(0);
#pragma unroll
      for (int k = 0; k < 2 * L; ++k) s += V[k] * g[k];
      const A vnew = (Z[L - 1] - s) / gcc;
#pragma unroll
      for (int k = MV - 1; k > 0; --k) V[k] = V[k - 1];
      V[0] = vnew;
      znew = (tj - gam * Z[0] - dsub * Z[1]) / dlt;
    } else {
      znew = tj - s_warm * Z[0];
    }
#pragma unroll
    for (int k = MZ - 1; k > 0; --k) Z[k] = Z[k - 1];
    Z[0] = znew;

    T* vo = Vo + j * MV;
    T* zo = Zo + j * MZ;
#pragma unroll
    for (int k = 0; k < MV; ++k) {
      const T sv = static_cast<T>(V[k]);
      vo[k] = sv;
      if (k <= L) d[k] += static_cast<A>(sv) * znew;
    }
#pragma unroll
    for (int k = 0; k < MZ; ++k) {
      const T sz = static_cast<T>(Z[k]);
      zo[k] = sz;
      if (k < L) d[L + 1 + k] += static_cast<A>(sz) * znew;
    }
  }
  block_sum_store<A, MV>(d, partial + static_cast<int64_t>(blockIdx.x) * MV);
}

template <typename T>
int fused_body(const void* Vw, const void* Zw, const void* scal, const void* t, int64_t n, int l,
               int64_t H, int64_t Wd, void* Vo, void* Zo, void* partial, void* dots,
               void* stream) {
  using A = typename AccOf<T>::type;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = reduce_blocks(n);
  A* part = static_cast<A*>(partial);
  const T* tt = static_cast<const T*>(t);
  const bool ok = dispatch_int<1, kMaxDepth>(l, [&](auto lc) {
    constexpr int L = decltype(lc)::value;
    if (tt == nullptr) {
      fused_body_kernel<T, L, true><<<nb, kThreads, 0, s>>>(
          static_cast<const T*>(Vw), static_cast<const T*>(Zw), static_cast<const A*>(scal),
          nullptr, n, H, Wd, static_cast<T*>(Vo), static_cast<T*>(Zo), part);
    } else {
      fused_body_kernel<T, L, false><<<nb, kThreads, 0, s>>>(
          static_cast<const T*>(Vw), static_cast<const T*>(Zw), static_cast<const A*>(scal),
          tt, n, H, Wd, static_cast<T*>(Vo), static_cast<T*>(Zo), part);
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum_partials<A>(part, nb, 2 * l + 1, static_cast<A*>(dots), s));
}

}  // namespace repro

extern "C" {

// t == nullptr selects the in-kernel stencil on the (H, W) grid.
int repro_fused_body_f32(const void* Vw, const void* Zw, const void* scal, const void* t,
                         int64_t n, int l, int64_t H, int64_t W, void* Vo, void* Zo,
                         void* partial, void* dots, void* stream) {
  return repro::fused_body<float>(Vw, Zw, scal, t, n, l, H, W, Vo, Zo, partial, dots, stream);
}

int repro_fused_body_f64(const void* Vw, const void* Zw, const void* scal, const void* t,
                         int64_t n, int l, int64_t H, int64_t W, void* Vo, void* Zo,
                         void* partial, void* dots, void* stream) {
  return repro::fused_body<double>(Vw, Zw, scal, t, n, l, H, W, Vo, Zo, partial, dots, stream);
}

}  // extern "C"
