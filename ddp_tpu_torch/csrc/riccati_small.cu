// Batched small-dimension Riccati backward sweep with augmented-Lagrangian
// terms, Gauss-Newton or full second order, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/riccati_small.py
// (_bwd_kernel, launched by _sweep_call's pl.pallas_call) on the
// backward="kernel" path of ddp_tpu_torch.solver.batched.solve_batched.
//
// Second order (template flag SO): six rank-3 slabs fxx [T, n*n*n, B],
// fux [T, n*m*n, B], fuu [T, n*m*m, B], eqxx, equx, equu (e in place of the
// leading n), row (o*r + i)*c + j, add  sum_o Vx[o]*f..[o][i][j] +
// sum_a tmp[a]*eq..[a][i][j]  to Qxx, Qux, Quu.  They are streamed: every
// entry is read once, coalesced over lanes, and folded into the accumulator
// it belongs to, so the second-order sweep keeps the first-order sweep's
// per-thread state.  With true Hessians Quu is indefinite far from an
// optimum; the NaN-gains / ok = false behaviour below is what the caller's
// regularization ladder relies on.
//
// Layout: every per-step input is [T, rows, B] (matrices flattened row-major
// into the middle axis), the batch last.  One thread owns one batch lane and
// runs the whole reverse time loop, holding (Vx, Vxx) in registers, so a
// load at (t, r, b) is coalesced across the warp by construction and nothing
// is carried between blocks.  The ragged edge (b >= B) is masked; any B is
// accepted.  The kernel allocates nothing: the wrapper allocates k, K, ok.
//
// Bound: device-memory bytes.  At the headline (n=2, m=1, e=1, T=32,
// B=4096, float) a sweep reads about 26 rows x 32 x 4096 x 4 B = 13.6 MB and
// writes a tenth of that: about 4 us at the H100's 3.35 TB/s, the same order
// as a launch.  4096 lanes at 128 threads per block make 32 blocks for 132
// SMs, so the card is far from full at that size; making the kernel fast
// (more lanes per SM, fewer bytes) is later work.  At the arm dims
// (12, 6, 6) and (14, 7, 3) a thread's live state spills to local memory.
//
// A failed factorization yields NaN through sqrt of a negative pivot, and
// the per-lane ok flag is L[i][i] > 0 && isfinite(L[i][i]) at every step:
// build without --use_fast_math and without -ftz, which would break both.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// x > 0 && isfinite(x): false for NaN (every comparison is) and for +inf
template <typename S>
__device__ __forceinline__ bool positive_finite(S x) {
  return x > S(0) && x < S(INFINITY);
}

template <typename S, int N, int M, int E, bool SO>
__global__ void __launch_bounds__(128) riccati_bwd_kernel(
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ lux,
    const S* __restrict__ luu, const S* __restrict__ fx,
    const S* __restrict__ fu, const S* __restrict__ eq,
    const S* __restrict__ eqx, const S* __restrict__ equ,
    const S* __restrict__ pe, const S* __restrict__ pex,
    const S* __restrict__ mu_in, const S* __restrict__ reg_in,
    const S* __restrict__ lfx, const S* __restrict__ lfxx,
    const S* __restrict__ fxx, const S* __restrict__ fux,
    const S* __restrict__ fuu, const S* __restrict__ eqxx,
    const S* __restrict__ equx, const S* __restrict__ equu,
    S* __restrict__ k_out, S* __restrict__ K_out, bool* __restrict__ ok_out,
    int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // element (t, r) of a [T, rows, B] array, this thread's lane
  auto at = [&](const S* p, int rows, int t, int r) -> S {
    return p[(static_cast<size_t>(t) * rows + r) * Bs + b];
  };

  const S mu = mu_in[b];
  const S reg = reg_in[b];
  S Vx[N], Vxx[N][N];
  for (int i = 0; i < N; ++i) {
    Vx[i] = lfx[i * Bs + b];
    for (int j = 0; j < N; ++j) Vxx[i][j] = lfxx[(i * N + j) * Bs + b];
  }
  bool ok = true;

  for (int t = T - 1; t >= 0; --t) {
    S eqv[E], tmp[E], tmp2[E][N];
    for (int a = 0; a < E; ++a) {
      eqv[a] = at(eq, E, t, a);
      tmp[a] = at(pe, E, t, a) + mu * eqv[a];
      for (int j = 0; j < N; ++j)
        tmp2[a][j] = at(pex, E * N, t, a * N + j) + mu * at(eqx, E * N, t, a * N + j);
    }
    // Qx = lx + fxᵀVx + eqxᵀtmp + pexᵀeq
    S Qx[N];
    for (int i = 0; i < N; ++i) {
      S s = at(lx, N, t, i);
      for (int o = 0; o < N; ++o) s = s + at(fx, N * N, t, o * N + i) * Vx[o];
      for (int a = 0; a < E; ++a)
        s = s + at(eqx, E * N, t, a * N + i) * tmp[a] + at(pex, E * N, t, a * N + i) * eqv[a];
      Qx[i] = s;
    }
    // Qu = lu + fuᵀVx + equᵀtmp
    S Qu[M];
    for (int i = 0; i < M; ++i) {
      S s = at(lu, M, t, i);
      for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vx[o];
      for (int a = 0; a < E; ++a) s = s + at(equ, E * M, t, a * M + i) * tmp[a];
      Qu[i] = s;
    }
    // Vfx = Vxx·fx, Vfu = Vxx·fu
    S Vfx[N][N], Vfu[N][M];
    for (int o = 0; o < N; ++o) {
      for (int j = 0; j < N; ++j) {
        S s = Vxx[o][0] * at(fx, N * N, t, j);
        for (int r = 1; r < N; ++r) s = s + Vxx[o][r] * at(fx, N * N, t, r * N + j);
        Vfx[o][j] = s;
      }
      for (int j = 0; j < M; ++j) {
        S s = Vxx[o][0] * at(fu, N * M, t, j);
        for (int r = 1; r < N; ++r) s = s + Vxx[o][r] * at(fu, N * M, t, r * M + j);
        Vfu[o][j] = s;
      }
    }
    // Qxx = lxx + fxᵀ(Vxx fx) + eqxᵀtmp2 + pexᵀeqx [+ Vx·fxx + tmp·eqxx];
    // written into Vxx, which is not read again this step
    for (int i = 0; i < N; ++i) {
      for (int j = 0; j < N; ++j) {
        S s = at(lxx, N * N, t, i * N + j);
        for (int o = 0; o < N; ++o) s = s + at(fx, N * N, t, o * N + i) * Vfx[o][j];
        for (int a = 0; a < E; ++a)
          s = s + at(eqx, E * N, t, a * N + i) * tmp2[a][j] +
              at(pex, E * N, t, a * N + i) * at(eqx, E * N, t, a * N + j);
        if constexpr (SO) {
          for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fxx, N * N * N, t, (o * N + i) * N + j);
          for (int a = 0; a < E; ++a) s = s + tmp[a] * at(eqxx, E * N * N, t, (a * N + i) * N + j);
        }
        Vxx[i][j] = s;
      }
    }
    // Quu = luu + fuᵀ(Vxx fu) + μ·equᵀequ [+ Vx·fuu + tmp·equu], factored
    // in place below
    S L[M][M];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < M; ++j) {
        S s = at(luu, M * M, t, i * M + j);
        for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vfu[o][j];
        for (int a = 0; a < E; ++a)
          s = s + mu * at(equ, E * M, t, a * M + i) * at(equ, E * M, t, a * M + j);
        if constexpr (SO) {
          for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fuu, N * M * M, t, (o * M + i) * M + j);
          for (int a = 0; a < E; ++a) s = s + tmp[a] * at(equu, E * M * M, t, (a * M + i) * M + j);
        }
        L[i][j] = s;
      }
    }
    // Qux = lux + fuᵀ(Vxx fx) + equᵀtmp2 [+ Vx·fux + tmp·equx]
    S Qux[M][N];
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j < N; ++j) {
        S s = at(lux, M * N, t, i * N + j);
        for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vfx[o][j];
        for (int a = 0; a < E; ++a) s = s + at(equ, E * M, t, a * M + i) * tmp2[a][j];
        if constexpr (SO) {
          for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fux, N * M * N, t, (o * M + i) * N + j);
          for (int a = 0; a < E; ++a) s = s + tmp[a] * at(equx, E * M * N, t, (a * M + i) * N + j);
        }
        Qux[i][j] = s;
      }
    }

    // Cholesky–Banachiewicz of Quu + reg·I (lower triangle of L)
    for (int i = 0; i < M; ++i) {
      for (int j = 0; j <= i; ++j) {
        S s = L[i][j] + (i == j ? reg : S(0));
        for (int q = 0; q < j; ++q) s = s - L[i][q] * L[j][q];
        L[i][j] = (i == j) ? root(s) : s / L[j][j];
      }
    }
    for (int i = 0; i < M; ++i) ok = ok && positive_finite(L[i][i]);

    // solve (Quu + reg·I)·x = rhs for rhs = Qu and each column j of Qux:
    // X[c] with c = 0 ↔ Qu, c = 1 + j ↔ Qux[:, j]
    S X[1 + N][M];
    for (int c = 0; c <= N; ++c) {
      for (int i = 0; i < M; ++i) {  // forward: L y = rhs
        S s = (c == 0) ? Qu[i] : Qux[i][c - 1];
        for (int q = 0; q < i; ++q) s = s - L[i][q] * X[c][q];
        X[c][i] = s / L[i][i];
      }
      for (int i = M - 1; i >= 0; --i) {  // backward: Lᵀ x = y
        S s = X[c][i];
        for (int q = i + 1; q < M; ++q) s = s - L[q][i] * X[c][q];
        X[c][i] = s / L[i][i];
      }
    }

    for (int i = 0; i < M; ++i) {
      k_out[(static_cast<size_t>(t) * M + i) * Bs + b] = -X[0][i];
      for (int j = 0; j < N; ++j)
        K_out[(static_cast<size_t>(t) * M * N + i * N + j) * Bs + b] = -X[1 + j][i];
    }
    // Vx' = Qx − Quxᵀ(Quu⁻¹Qu);  Vxx' = Qxx − Quxᵀ(Quu⁻¹Qux)
    for (int i = 0; i < N; ++i) {
      S s = Qx[i];
      for (int o = 0; o < M; ++o) s = s - Qux[o][i] * X[0][o];
      Vx[i] = s;
    }
    for (int i = 0; i < N; ++i) {
      for (int j = 0; j < N; ++j) {
        S s = Vxx[i][j];
        for (int o = 0; o < M; ++o) s = s - Qux[o][i] * X[1 + j][o];
        Vxx[i][j] = s;
      }
    }
  }
  ok_out[b] = ok;
}

template <typename S, int N, int M, int E, bool SO>
int launch(const void* const* in, void* k, void* K, void* ok, int T, int B,
           cudaStream_t stream) {
  const S* p[22];
  for (int i = 0; i < 22; ++i) p[i] = (i < 16 || SO) ? static_cast<const S*>(in[i]) : nullptr;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  riccati_bwd_kernel<S, N, M, E, SO><<<blocks, threads, 0, stream>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11],
      p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19], p[20], p[21],
      static_cast<S*>(k), static_cast<S*>(K), static_cast<bool*>(ok), T, B);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int M, int E, bool SO>
int launch_dtype(int is_double, const void* const* in, void* k, void* K,
                 void* ok, int T, int B, cudaStream_t s) {
  return is_double ? launch<double, N, M, E, SO>(in, k, K, ok, T, B, s)
                   : launch<float, N, M, E, SO>(in, k, K, ok, T, B, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``in`` points at 16 device
// pointers in the order lx, lu, lxx, lux, luu, fx, fu, eq, eqx, equ, pe,
// pex, mu, reg, lfx, lfxx, followed with ``second_order`` by fxx, fux, fuu,
// eqxx, equx, equu.  Returns cudaGetLastError() after the launch; -1 for
// dims, an order or a dtype this build does not instantiate.
extern "C" int ddp_riccati_small_bwd(int is_double, int second_order, int n,
                                     int m, int e, int T, int B,
                                     const void* const* in, void* k, void* K,
                                     void* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;  // an empty grid is not a valid launch
  if (second_order) {
    if (n == 2 && m == 1 && e == 1)
      return launch_dtype<2, 1, 1, true>(is_double, in, k, K, ok, T, B, s);
    if (n == 4 && m == 2 && e == 2)
      return launch_dtype<4, 2, 2, true>(is_double, in, k, K, ok, T, B, s);
    if (n == 14 && m == 7 && e == 3)
      return launch_dtype<14, 7, 3, true>(is_double, in, k, K, ok, T, B, s);
    return -1;
  }
  if (n == 2 && m == 1 && e == 1)
    return launch_dtype<2, 1, 1, false>(is_double, in, k, K, ok, T, B, s);
  if (n == 12 && m == 6 && e == 6)
    return launch_dtype<12, 6, 6, false>(is_double, in, k, K, ok, T, B, s);
  if (n == 14 && m == 7 && e == 3)
    return launch_dtype<14, 7, 3, false>(is_double, in, k, K, ok, T, B, s);
  return -1;
}
