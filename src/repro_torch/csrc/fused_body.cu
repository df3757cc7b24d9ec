// Hand-written Hopper kernel for the fused p(l)-CG iteration body: in ONE
// pass over the lane-major windows Vw (n, 2l+1), Zw (n, l+1) and, when
// preconditioned, Zhw (n, 3) it computes
//   (K1) t_hat = A z_0, the zero-Dirichlet 5-point stencil on the (H, W) grid
//        of Zw[:, 0], rounded to the storage type -- or reads a streamed
//        t_hat (and t);
//        with a diagonal preconditioner, t = invd * t_hat rounded to the
//        storage type (invd a scalar in scal[6], or an (n,) operand);
//   (K4) v_new = (z_{l-1} - sum_k g_k V[:, k]) / gcc   (steady bodies only)
//        z_new = (t - gam z_0 - dsub z_1) / dlt        (steady)
//              =  t - s_warm z_0                      (warmup)
//        zh_new the same recurrence on the zhat window with t_hat,
//        and writes the shifted windows Vw2, Zw2 (, Zhw2);
//   (K5) the 2l+1 payload dots [<Vw2[:, k], lhs>]_{k<=l}, [<Zw2[:, k], lhs>]_{k<l}
//        against the updated windows as stored, with lhs = zh_new when the
//        zhat window is present and z_new otherwise.
// The scalars arrive packed in one device vector
//   scal = [steady, s_warm, gam, dlt, dsub, gcc, invd, g_0 .. g_{2l-1}]
// written by the engine's scalar block; nothing is read back to the host.
// The seven operand combinations the reference admits:
//   stencil | stencil + zh + diag | streamed t | streamed t + t_hat + zh |
//   streamed t_hat + zh + diag        (diag: scalar or vector)
//
// Replaces the Pallas TPU megakernel src/repro/kernels/fused_body.py::fused_body
// (_make_kernel).
//
// Bound on the H100: bytes.  Each body reads Vw and Zw once and writes Vw2 and
// Zw2 once: 2 (3l+2) n words; the zhat window adds 6n, a streamed t or t_hat
// n each, a vector invd n.  About 50 flops a row.  Design:
//  * one grid row per thread in a grid-stride loop; the row's window entries
//    and the 2l+1 dot accumulators live in registers (l is a template
//    parameter; so are the in-kernel stencil and the zhat window, while the
//    diag mode is a warp-uniform runtime branch, which keeps the build at
//    4 variants per l and type);
//  * the stencil reads the four neighbours of Zw[j, 0] directly from the
//    input window; neighbours of the flattened (H, W) grid are zero across
//    the grid's edges (row r = j / W, column c = j % W are masked, so j +- 1
//    never wraps into the next grid row and H need not be a power of two);
//  * because other blocks read Zw[:, 0] as stencil neighbours while this
//    block writes, the outputs go to separate buffers (the engine ping-pongs
//    two window sets) -- the input windows are never written;
//  * the dot payload is reduced with the deterministic two-pass reduction of
//    reduce.cuh (no float atomics).
#include "reduce.cuh"

namespace repro {

constexpr int kFixedScalars = 7;  // steady, s_warm, gam, dlt, dsub, gcc, invd
constexpr int kZh = 3;            // columns of the zhat window
enum Diag : int { kDiagNone = 0, kDiagScalar = 1, kDiagVector = 2 };

template <typename T, int L, bool STENCIL, bool ZH>
__global__ void __launch_bounds__(kThreads)
    fused_body_kernel(const T* __restrict__ Vw, const T* __restrict__ Zw,
                      const T* __restrict__ Zhw, const typename AccOf<T>::type* __restrict__ scal,
                      const T* __restrict__ t, const T* __restrict__ t_hat,
                      const T* __restrict__ invd, int diag, int64_t n, int64_t H, int64_t Wd,
                      T* __restrict__ Vo, T* __restrict__ Zo, T* __restrict__ Zho,
                      typename AccOf<T>::type* __restrict__ partial) {
  using A = typename AccOf<T>::type;
  constexpr int MV = 2 * L + 1;
  constexpr int MZ = L + 1;
  const bool steady = scal[0] > A(0.5);
  const A s_warm = scal[1], gam = scal[2], dlt = scal[3], dsub = scal[4], gcc = scal[5];
  const A inv_s = scal[6];
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

    // (K1) t_hat: in-kernel stencil (rounded to storage) or streamed
    A th = A(0);
    if constexpr (STENCIL) {
      const int64_t r = j / Wd;
      const int64_t c = j - r * Wd;
      const A up = r > 0 ? static_cast<A>(Zw[(j - Wd) * MZ]) : A(0);
      const A down = r < H - 1 ? static_cast<A>(Zw[(j + Wd) * MZ]) : A(0);
      const A left = c > 0 ? static_cast<A>(Zw[(j - 1) * MZ]) : A(0);
      const A right = c < Wd - 1 ? static_cast<A>(Zw[(j + 1) * MZ]) : A(0);
      th = static_cast<A>(static_cast<T>(A(4) * Z[0] - up - down - left - right));
    } else if (t_hat != nullptr) {
      th = static_cast<A>(t_hat[j]);
    }
    // t: the diagonal preconditioner applied to t_hat, t_hat itself, or streamed
    A tj;
    if (diag != kDiagNone) {
      const A iv = diag == kDiagScalar ? inv_s : static_cast<A>(invd[j]);
      tj = static_cast<A>(static_cast<T>(iv * th));
    } else if constexpr (STENCIL) {
      tj = th;
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

    A lhs = znew;
    if constexpr (ZH) {
      const T* hr = Zhw + j * kZh;
      const T zh0 = hr[0], zh1 = hr[1];
      lhs = steady ? (th - gam * static_cast<A>(zh0) - dsub * static_cast<A>(zh1)) / dlt
                   : th - s_warm * static_cast<A>(zh0);
      T* ho = Zho + j * kZh;
      ho[0] = static_cast<T>(lhs);
      ho[1] = zh0;
      ho[2] = zh1;
    }

    T* vo = Vo + j * MV;
    T* zo = Zo + j * MZ;
#pragma unroll
    for (int k = 0; k < MV; ++k) {
      const T sv = static_cast<T>(V[k]);
      vo[k] = sv;
      if (k <= L) d[k] += static_cast<A>(sv) * lhs;
    }
#pragma unroll
    for (int k = 0; k < MZ; ++k) {
      const T sz = static_cast<T>(Z[k]);
      zo[k] = sz;
      if (k < L) d[L + 1 + k] += static_cast<A>(sz) * lhs;
    }
  }
  block_sum_store<A, MV>(d, partial + static_cast<int64_t>(blockIdx.x) * MV);
}

template <typename T>
int fused_body(const void* Vw, const void* Zw, const void* Zhw, const void* scal, const void* t,
               const void* t_hat, const void* invd, int64_t n, int l, int diag, int64_t H,
               int64_t Wd, void* Vo, void* Zo, void* Zho, void* partial, void* dots,
               void* stream) {
  using A = typename AccOf<T>::type;
  if (diag < kDiagNone || diag > kDiagVector) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = reduce_blocks(n);
  A* part = static_cast<A*>(partial);
  const bool stencil = H > 0;
  const bool zh = Zhw != nullptr;
  const bool ok = dispatch_int<1, kMaxDepth>(l, [&](auto lc) {
    constexpr int L = decltype(lc)::value;
    auto launch = [&](auto st, auto hz) {
      fused_body_kernel<T, L, decltype(st)::value, decltype(hz)::value><<<nb, kThreads, 0, s>>>(
          static_cast<const T*>(Vw), static_cast<const T*>(Zw), static_cast<const T*>(Zhw),
          static_cast<const A*>(scal), static_cast<const T*>(t), static_cast<const T*>(t_hat),
          static_cast<const T*>(invd), diag, n, H, Wd, static_cast<T*>(Vo), static_cast<T*>(Zo),
          static_cast<T*>(Zho), part);
    };
    using Yes = std::true_type;
    using No = std::false_type;
    if (stencil) {
      zh ? launch(Yes{}, Yes{}) : launch(Yes{}, No{});
    } else {
      zh ? launch(No{}, Yes{}) : launch(No{}, No{});
    }
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum_partials<A>(part, nb, 2 * l + 1, static_cast<A*>(dots), s));
}

}  // namespace repro

extern "C" {

// H > 0 selects the in-kernel stencil on the (H, W) grid (t, t_hat null);
// Zhw != null adds the zhat window (Zho its output); diag is 0 none,
// 1 scalar (invd in scal[6]), 2 vector (the (n,) operand invd).
int repro_fused_body_f32(const void* Vw, const void* Zw, const void* Zhw, const void* scal,
                         const void* t, const void* t_hat, const void* invd, int64_t n, int l,
                         int diag, int64_t H, int64_t W, void* Vo, void* Zo, void* Zho,
                         void* partial, void* dots, void* stream) {
  return repro::fused_body<float>(Vw, Zw, Zhw, scal, t, t_hat, invd, n, l, diag, H, W, Vo, Zo,
                                  Zho, partial, dots, stream);
}

int repro_fused_body_f64(const void* Vw, const void* Zw, const void* Zhw, const void* scal,
                         const void* t, const void* t_hat, const void* invd, int64_t n, int l,
                         int diag, int64_t H, int64_t W, void* Vo, void* Zo, void* Zho,
                         void* partial, void* dots, void* stream) {
  return repro::fused_body<double>(Vw, Zw, Zhw, scal, t, t_hat, invd, n, l, diag, H, W, Vo, Zo,
                                   Zho, partial, dots, stream);
}

}  // extern "C"
