// Batched small-dimension Riccati backward sweep with augmented-Lagrangian
// terms, Gauss-Newton or full second order, for NVIDIA Hopper (sm_90a): the
// whole regularization ladder of one backward call in one launch.
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/riccati_small.py
// (_bwd_kernel, launched by _sweep_call's pl.pallas_call once per reg level)
// on the backward="kernel" path of ddp_tpu_torch.solver.batched.solve_batched.
//
// The function: per lane b and reg level l of levels [L, B], the AL-DDP
// sweep over t = T-1 … 0
//
//     Qx = lx + fxᵀVx + eqxᵀtmp + pexᵀeq,   Qu = lu + fuᵀVx + equᵀtmp,
//     Qxx = lxx + fxᵀVxx fx + eqxᵀtmp2 + pexᵀeqx [+ Vx·fxx + tmp·eqxx],
//     Quu = luu + fuᵀVxx fu + μ equᵀequ [+ Vx·fuu + tmp·equu],
//     Qux = lux + fuᵀVxx fx + equᵀtmp2 [+ Vx·fux + tmp·equx],
//     tmp = pe + μ eq,  tmp2 = pex + μ eqx,
//
// an unrolled Cholesky of Quu + reg_l·I, k = -Quu⁻¹Qu, K = -Quu⁻¹Qux,
// Vx = Qx + Quxᵀk, Vxx = Qxx + QuxᵀK; a level holds when every pivot is
// positive and finite.  The call returns, per lane, the gains of the first
// level that held, ok = any level held, and that level's reg; a lane no
// level saved keeps level 0's (NaN) gains and reg.  The bracketed terms are
// the second-order (full DDP) contractions with the rank-3 slabs, row
// (o*r + i)*c + j.
//
// Two programs.
//
// Large dims, 12 <= n <= 31 (UR5 (12, 6, 6), the quadrotor (12, 6, 12),
// panda7 (14, 7, 3)): one block per lane, one warp per level.  Inputs are
// read lane-major, straight from the batch-major [B, T, ...] tensors of
// Derivs (a lane's step slab is contiguous): the block
// copies lane b's step t-1 into shared memory with cp.async (4- or 8-byte
// granules: slabs of 7, 21, 49 or 98 values neither start nor end on 16
// bytes) while step t computes, once for all its levels.  The level-free
// part of the Q blocks (everything but the Vx/Vxx terms) is formed once per
// step by the whole block.  Each warp keeps its level's Vx, Vxx and Q blocks
// in shared memory and spreads the products one output entry per thread;
// the m x m Cholesky runs column by column over the warp (pivot, then the
// column below it in parallel, the same sums in the same order as a serial
// Cholesky-Banachiewicz), and the 1 + n right-hand sides are solved one
// column per thread.  Plain FMA in the working type: no tensor cores, no
// TF32 (ddp_tpu pins this sweep to full precision).  Each level writes its
// gains to the wrapper's scratch; at the end the block copies the chosen
// level's to the batch-major k [B, T, m], K [B, T, m, n] (a one-level call
// writes them there directly).
//
// Small dims, n < 12 (the pendulum (2, 1, ·), the double pendulum (4, 2, 2)):
// one thread per lane and level, state in registers, inputs read batch-major
// like the large-dims program's (a lane's slab of a field over all T steps is
// contiguous, so a warp's load is 32 sectors apart).  The kernel alone is
// slower than over a batch-last copy, but the call is faster, since it makes
// no copy (examples/torch_riccati_layout.py).  A block is 32 lanes x L levels, which meet in
// shared memory for the choice.  4096 lanes make 128 blocks.
//
// Bound: at (14, 7, 3), T = 16, B = 256, four levels the multiply-adds of
// four sweeps at the float32 peak (~7 us), the bytes a little less; a
// second-order call reads 110 MB (~33 us).  The design keeps every SM busy
// (a block per lane) and every live value in shared memory or registers.
//
// A failed factorization yields NaN through sqrt of a negative pivot, and
// the ok flag needs IEEE comparisons: build without --use_fast_math and
// without -ftz.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxLevels = 16;

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// x > 0 && isfinite(x): false for NaN (every comparison is) and for +inf
template <typename S>
__device__ __forceinline__ bool positive_finite(S x) {
  return x > S(0) && x < S(INFINITY);
}

// The 22 per-step inputs in the order of the C entry point: lx, lu, lxx,
// lux, luu, fx, fu, eq, eqx, equ, pe, pex, then with SO fxx, fux, fuu, eqxx,
// equx, equu; mu [B], levels [L, B], lfx [B, n], lfxx [B, n*n].
enum Field { LX, LU, LXX, LUX, LUU, FX, FU, EQ, EQX, EQU, PE, PEX,
             FXX, FUX, FUU, EQXX, EQUX, EQUU, N_FIELDS };

template <typename S>
struct Args {
  const S* in[N_FIELDS];
  const S* mu;
  const S* levels;
  const S* lfx;
  const S* lfxx;
  S* ks;      // scratch: per level gains (unused when L == 1)
  S* Ks;
  S* k_out;   // [B, T, m]
  S* K_out;   // [B, T, m, n]
  bool* ok_out;
  S* reg_out;
  int T, B, L;
};

// values a lane has of field f at one step
template <int N, int M, int E>
__host__ __device__ constexpr int rows_of(int f) {
  switch (f) {
    case LX: return N;
    case LU: return M;
    case LXX: return N * N;
    case LUX: return M * N;
    case LUU: return M * M;
    case FX: return N * N;
    case FU: return N * M;
    case EQ: return E;
    case EQX: return E * N;
    case EQU: return E * M;
    case PE: return E;
    case PEX: return E * N;
    case FXX: return N * N * N;
    case FUX: return N * M * N;
    case FUU: return N * M * M;
    case EQXX: return E * N * N;
    case EQUX: return E * M * N;
    case EQUU: return E * M * M;
    default: return 0;
  }
}

// ------------------------------------------------------------ large dims

template <int N, int M, int E, bool SO>
struct Layout {
  // per-step inputs, one after the other in a buffer
  static constexpr int n_fields = SO ? N_FIELDS : FXX;
  static __host__ __device__ constexpr int off(int f) {
    int o = 0;
    for (int i = 0; i < f; ++i) o += rows_of<N, M, E>(i);
    return o;
  }
  static constexpr int IN = off(n_fields);
  // level-free part of a step: tmp, tmp2, Qx0, Qu0, Qxx0, Quu0, Qux0
  static constexpr int TMP = 0, TMP2 = E, QX0 = TMP2 + E * N, QU0 = QX0 + N,
                       QXX0 = QU0 + M, QUU0 = QXX0 + N * N, QUX0 = QUU0 + M * M,
                       BASE = QUX0 + M * N;
  // one level: Vx, Vxx (Qxx once formed, then Vxx again), Vfx, Vfu, Qx, Qu,
  // Qux, Lc (Quu, then its factor), X (1 + n solved columns of length m)
  static constexpr int VX = 0, VXX = N, VFX = VXX + N * N, VFU = VFX + N * N,
                       QX = VFU + N * M, QU = QX + N, QUX = QU + M,
                       LC = QUX + M * N, XS = LC + M * M, LEVEL = XS + (1 + N) * M;
  static constexpr size_t bytes(int L, size_t item) {
    return (2 * size_t(IN) + BASE + size_t(L) * LEVEL) * item + size_t(L) * sizeof(int);
  }
};

template <typename S, int N, int M, int E, bool SO>
__device__ __forceinline__ void prefetch_step(const Args<S>& a, S* buf, int b, int t,
                                              int tid, int nthreads) {
  using Ly = Layout<N, M, E, SO>;
  const size_t step = static_cast<size_t>(b) * a.T + t;
#pragma unroll
  for (int f = 0; f < Ly::n_fields; ++f) {
    const int rows = rows_of<N, M, E>(f);
    const S* src = a.in[f] + step * rows;
    S* dst = buf + Ly::off(f);
    for (int i = tid; i < rows; i += nthreads)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(S));
  }
  __pipeline_commit();
}

template <typename S, int N, int M, int E, bool SO>
__global__ void __launch_bounds__(32 * kMaxLevels, 1) ladder_large_kernel(const Args<S> a) {
  using Ly = Layout<N, M, E, SO>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const smem = reinterpret_cast<S*>(smem_raw);
  S* const bufs = smem;                      // [2][IN]
  S* const base = smem + 2 * Ly::IN;         // [BASE]
  S* const lvl0 = base + Ly::BASE;           // [L][LEVEL]
  int* const ok_s = reinterpret_cast<int*>(lvl0 + a.L * Ly::LEVEL);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int w = tid >> 5, lane = tid & 31;
  const int T = a.T, B = a.B, L = a.L;
  const bool direct = (L == 1);  // one level: gains straight to the outputs
  const S mu = a.mu[b];
  const S reg = a.levels[static_cast<size_t>(w) * B + b];
  S* const st = lvl0 + w * Ly::LEVEL;
  S* const Vx = st + Ly::VX;
  S* const Vxx = st + Ly::VXX;
  S* const Vfx = st + Ly::VFX;
  S* const Vfu = st + Ly::VFU;
  S* const Qx = st + Ly::QX;
  S* const Qu = st + Ly::QU;
  S* const Qux = st + Ly::QUX;
  S* const Lc = st + Ly::LC;
  S* const X = st + Ly::XS;
  S* const k_dst = direct ? a.k_out : a.ks + static_cast<size_t>(w) * B * T * M;
  S* const K_dst = direct ? a.K_out : a.Ks + static_cast<size_t>(w) * B * T * M * N;

  for (int i = lane; i < N; i += 32) Vx[i] = a.lfx[static_cast<size_t>(b) * N + i];
  for (int i = lane; i < N * N; i += 32) Vxx[i] = a.lfxx[static_cast<size_t>(b) * N * N + i];
  bool ok = true;

  prefetch_step<S, N, M, E, SO>(a, bufs, b, T - 1, tid, nthreads);
  for (int t = T - 1; t >= 0; --t) {
    S* const in = bufs + ((T - 1 - t) & 1) * Ly::IN;
    __pipeline_wait_prior(0);
    __syncthreads();  // step t landed for every thread; step t+1 consumed
    if (t > 0)
      prefetch_step<S, N, M, E, SO>(a, bufs + ((T - t) & 1) * Ly::IN, b, t - 1, tid, nthreads);
    const S* const lx = in + Ly::off(LX);
    const S* const lu = in + Ly::off(LU);
    const S* const lxx = in + Ly::off(LXX);
    const S* const lux = in + Ly::off(LUX);
    const S* const luu = in + Ly::off(LUU);
    const S* const fx = in + Ly::off(FX);
    const S* const fu = in + Ly::off(FU);
    const S* const eq = in + Ly::off(EQ);
    const S* const eqx = in + Ly::off(EQX);
    const S* const equ = in + Ly::off(EQU);
    const S* const pe = in + Ly::off(PE);
    const S* const pex = in + Ly::off(PEX);
    S* const tmp = base + Ly::TMP;
    S* const tmp2 = base + Ly::TMP2;

    // the level-free part of the step, once for the block
    for (int i = tid; i < E + E * N; i += nthreads) {
      if (i < E) tmp[i] = pe[i] + mu * eq[i];
      else tmp2[i - E] = pex[i - E] + mu * eqx[i - E];
    }
    __syncthreads();
    for (int idx = tid; idx < Ly::BASE - Ly::QX0; idx += nthreads) {
      const int o = Ly::QX0 + idx;
      S s;
      if (o < Ly::QU0) {  // lx + eqxᵀtmp + pexᵀeq
        const int i = o - Ly::QX0;
        s = lx[i];
        for (int q = 0; q < E; ++q) s = s + eqx[q * N + i] * tmp[q] + pex[q * N + i] * eq[q];
      } else if (o < Ly::QXX0) {  // lu + equᵀtmp
        const int i = o - Ly::QU0;
        s = lu[i];
        for (int q = 0; q < E; ++q) s = s + equ[q * M + i] * tmp[q];
      } else if (o < Ly::QUU0) {  // lxx + eqxᵀtmp2 + pexᵀeqx [+ tmp·eqxx]
        const int i = (o - Ly::QXX0) / N, j = (o - Ly::QXX0) % N;
        s = lxx[i * N + j];
        for (int q = 0; q < E; ++q)
          s = s + eqx[q * N + i] * tmp2[q * N + j] + pex[q * N + i] * eqx[q * N + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(EQXX);
          for (int q = 0; q < E; ++q) s = s + tmp[q] * h[(q * N + i) * N + j];
        }
      } else if (o < Ly::QUX0) {  // luu + μ equᵀequ [+ tmp·equu]
        const int i = (o - Ly::QUU0) / M, j = (o - Ly::QUU0) % M;
        s = luu[i * M + j];
        for (int q = 0; q < E; ++q) s = s + mu * equ[q * M + i] * equ[q * M + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(EQUU);
          for (int q = 0; q < E; ++q) s = s + tmp[q] * h[(q * M + i) * M + j];
        }
      } else {  // lux + equᵀtmp2 [+ tmp·equx]
        const int i = (o - Ly::QUX0) / N, j = (o - Ly::QUX0) % N;
        s = lux[i * N + j];
        for (int q = 0; q < E; ++q) s = s + equ[q * M + i] * tmp2[q * N + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(EQUX);
          for (int q = 0; q < E; ++q) s = s + tmp[q] * h[(q * M + i) * N + j];
        }
      }
      base[o] = s;
    }
    __syncthreads();

    // this warp's level: Vfx = Vxx·fx, Vfu = Vxx·fu, Qx, Qu
    for (int idx = lane; idx < N * N + N * M + N + M; idx += 32) {
      if (idx < N * N) {
        const int o = idx / N, j = idx % N;
        S s = Vxx[o * N] * fx[j];
        for (int r = 1; r < N; ++r) s = s + Vxx[o * N + r] * fx[r * N + j];
        Vfx[idx] = s;
      } else if (idx < N * N + N * M) {
        const int o = (idx - N * N) / M, j = (idx - N * N) % M;
        S s = Vxx[o * N] * fu[j];
        for (int r = 1; r < N; ++r) s = s + Vxx[o * N + r] * fu[r * M + j];
        Vfu[o * M + j] = s;
      } else if (idx < N * N + N * M + N) {
        const int i = idx - N * N - N * M;
        S s = base[Ly::QX0 + i];
        for (int o = 0; o < N; ++o) s = s + fx[o * N + i] * Vx[o];
        Qx[i] = s;
      } else {
        const int i = idx - N * N - N * M - N;
        S s = base[Ly::QU0 + i];
        for (int o = 0; o < N; ++o) s = s + fu[o * M + i] * Vx[o];
        Qu[i] = s;
      }
    }
    __syncwarp();
    // Qxx (into Vxx, read no more this step), Quu (into Lc), Qux
    for (int idx = lane; idx < N * N + M * M + M * N; idx += 32) {
      if (idx < N * N) {
        const int i = idx / N, j = idx % N;
        S s = base[Ly::QXX0 + idx];
        for (int o = 0; o < N; ++o) s = s + fx[o * N + i] * Vfx[o * N + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(FXX);
          for (int o = 0; o < N; ++o) s = s + Vx[o] * h[(o * N + i) * N + j];
        }
        Vxx[idx] = s;
      } else if (idx < N * N + M * M) {
        const int c = idx - N * N, i = c / M, j = c % M;
        S s = base[Ly::QUU0 + c];
        for (int o = 0; o < N; ++o) s = s + fu[o * M + i] * Vfu[o * M + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(FUU);
          for (int o = 0; o < N; ++o) s = s + Vx[o] * h[(o * M + i) * M + j];
        }
        Lc[c] = s;
      } else {
        const int c = idx - N * N - M * M, i = c / N, j = c % N;
        S s = base[Ly::QUX0 + c];
        for (int o = 0; o < N; ++o) s = s + fu[o * M + i] * Vfx[o * N + j];
        if constexpr (SO) {
          const S* h = in + Ly::off(FUX);
          for (int o = 0; o < N; ++o) s = s + Vx[o] * h[(o * M + i) * N + j];
        }
        Qux[c] = s;
      }
    }
    __syncwarp();
    // Cholesky of Quu + reg·I, column by column: the pivot, then the column
    // below it, one row per thread (lower triangle of Lc)
    for (int j = 0; j < M; ++j) {
      if (lane == 0) {
        S s = Lc[j * M + j] + reg;
        for (int q = 0; q < j; ++q) s = s - Lc[j * M + q] * Lc[j * M + q];
        Lc[j * M + j] = root(s);
      }
      __syncwarp();
      const int i = j + 1 + lane;
      if (i < M) {
        S s = Lc[i * M + j];
        for (int q = 0; q < j; ++q) s = s - Lc[i * M + q] * Lc[j * M + q];
        Lc[i * M + j] = s / Lc[j * M + j];
      }
      __syncwarp();
    }
    for (int i = 0; i < M; ++i) ok = ok && positive_finite(Lc[i * M + i]);
    // (Quu + reg·I) x = rhs for rhs = Qu (c = 0) and column c-1 of Qux,
    // one right-hand side per thread
    if (lane <= N) {
      const int c = lane;
      S x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {  // forward: L y = rhs
        S s = (c == 0) ? Qu[i] : Qux[i * N + c - 1];
#pragma unroll
        for (int q = 0; q < i; ++q) s = s - Lc[i * M + q] * x[q];
        x[i] = s / Lc[i * M + i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {  // backward: Lᵀ x = y
        S s = x[i];
#pragma unroll
        for (int q = i + 1; q < M; ++q) s = s - Lc[q * M + i] * x[q];
        x[i] = s / Lc[i * M + i];
      }
      const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        X[c * M + i] = x[i];
        if (c == 0) k_dst[row * M + i] = -x[i];
        else K_dst[(row * M + i) * N + c - 1] = -x[i];
      }
    }
    __syncwarp();
    // Vx' = Qx − Quxᵀ(Quu⁻¹Qu);  Vxx' = Qxx − Quxᵀ(Quu⁻¹Qux), in place
    for (int idx = lane; idx < N * N + N; idx += 32) {
      if (idx < N * N) {
        const int i = idx / N, j = idx % N;
        S s = Vxx[idx];
        for (int o = 0; o < M; ++o) s = s - Qux[o * N + i] * X[(1 + j) * M + o];
        Vxx[idx] = s;
      } else {
        const int i = idx - N * N;
        S s = Qx[i];
        for (int o = 0; o < M; ++o) s = s - Qux[o * N + i] * X[o];
        Vx[i] = s;
      }
    }
    __syncwarp();
  }

  if (lane == 0) ok_s[w] = ok;
  __syncthreads();  // every level's ok flag and scratch gains are in
  int chosen = 0;
  bool any = false;
  for (int l = 0; l < L; ++l) {
    if (ok_s[l]) {
      chosen = l;
      any = true;
      break;
    }
  }
  if (tid == 0) {
    a.ok_out[b] = any;
    a.reg_out[b] = a.levels[static_cast<size_t>(chosen) * B + b];
  }
  if (!direct) {
    const size_t nk = static_cast<size_t>(T) * M, nK = nk * N;
    const S* ks = a.ks + (static_cast<size_t>(chosen) * B + b) * nk;
    const S* Ks = a.Ks + (static_cast<size_t>(chosen) * B + b) * nK;
    for (size_t i = tid; i < nk; i += nthreads) a.k_out[b * nk + i] = ks[i];
    for (size_t i = tid; i < nK; i += nthreads) a.K_out[b * nK + i] = Ks[i];
  }
}

// ------------------------------------------------------------ small dims

template <typename S, int N, int M, int E, bool SO>
__global__ void __launch_bounds__(32 * kMaxLevels, 1) ladder_small_kernel(const Args<S> a) {
  __shared__ int ok_s[kMaxLevels][32];
  const int T = a.T, B = a.B, L = a.L;
  const int lvl = threadIdx.y;
  const int b = blockIdx.x * 32 + threadIdx.x;
  const bool active = b < B;
  const bool direct = (L == 1);
  const size_t Bs = static_cast<size_t>(B);
  bool ok = true;
  if (active) {
    // element (t, r) of a batch-major [B, T, rows] input, this thread's lane
    auto at = [&](const S* p, int rows, int t, int r) -> S {
      return p[(static_cast<size_t>(b) * T + t) * rows + r];
    };
    const S *lx = a.in[LX], *lu = a.in[LU], *lxx = a.in[LXX], *lux = a.in[LUX],
            *luu = a.in[LUU], *fx = a.in[FX], *fu = a.in[FU], *eq = a.in[EQ],
            *eqx = a.in[EQX], *equ = a.in[EQU], *pe = a.in[PE], *pex = a.in[PEX],
            *fxx = a.in[FXX], *fux = a.in[FUX], *fuu = a.in[FUU], *eqxx = a.in[EQXX],
            *equx = a.in[EQUX], *equu = a.in[EQUU];
    // gains: batch-last per-level scratch, or the batch-major outputs
    auto put_k = [&](int t, int i, S v) {
      if (direct) a.k_out[(static_cast<size_t>(b) * T + t) * M + i] = v;
      else a.ks[((static_cast<size_t>(lvl) * T + t) * M + i) * Bs + b] = v;
    };
    auto put_K = [&](int t, int i, int j, S v) {
      if (direct) a.K_out[((static_cast<size_t>(b) * T + t) * M + i) * N + j] = v;
      else a.Ks[((static_cast<size_t>(lvl) * T + t) * M * N + i * N + j) * Bs + b] = v;
    };
    const S mu = a.mu[b];
    const S reg = a.levels[lvl * Bs + b];
    S Vx[N], Vxx[N][N];
    for (int i = 0; i < N; ++i) {
      Vx[i] = a.lfx[b * N + i];
      for (int j = 0; j < N; ++j) Vxx[i][j] = a.lfxx[(static_cast<size_t>(b) * N + i) * N + j];
    }

    for (int t = T - 1; t >= 0; --t) {
      S eqv[E], tmp[E], tmp2[E][N];
      for (int q = 0; q < E; ++q) {
        eqv[q] = at(eq, E, t, q);
        tmp[q] = at(pe, E, t, q) + mu * eqv[q];
        for (int j = 0; j < N; ++j) tmp2[q][j] = at(pex, E * N, t, q * N + j) + mu * at(eqx, E * N, t, q * N + j);
      }
      S Qx[N];
      for (int i = 0; i < N; ++i) {
        S s = at(lx, N, t, i);
        for (int q = 0; q < E; ++q)
          s = s + at(eqx, E * N, t, q * N + i) * tmp[q] + at(pex, E * N, t, q * N + i) * eqv[q];
        for (int o = 0; o < N; ++o) s = s + at(fx, N * N, t, o * N + i) * Vx[o];
        Qx[i] = s;
      }
      S Qu[M];
      for (int i = 0; i < M; ++i) {
        S s = at(lu, M, t, i);
        for (int q = 0; q < E; ++q) s = s + at(equ, E * M, t, q * M + i) * tmp[q];
        for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vx[o];
        Qu[i] = s;
      }
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
      // Qxx into Vxx (not read again this step)
      for (int i = 0; i < N; ++i) {
        for (int j = 0; j < N; ++j) {
          S s = at(lxx, N * N, t, i * N + j);
          for (int q = 0; q < E; ++q)
            s = s + at(eqx, E * N, t, q * N + i) * tmp2[q][j] +
                at(pex, E * N, t, q * N + i) * at(eqx, E * N, t, q * N + j);
          if constexpr (SO)
            for (int q = 0; q < E; ++q) s = s + tmp[q] * at(eqxx, E * N * N, t, (q * N + i) * N + j);
          for (int o = 0; o < N; ++o) s = s + at(fx, N * N, t, o * N + i) * Vfx[o][j];
          if constexpr (SO)
            for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fxx, N * N * N, t, (o * N + i) * N + j);
          Vxx[i][j] = s;
        }
      }
      S Lc[M][M];
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j < M; ++j) {
          S s = at(luu, M * M, t, i * M + j);
          for (int q = 0; q < E; ++q) s = s + mu * at(equ, E * M, t, q * M + i) * at(equ, E * M, t, q * M + j);
          if constexpr (SO)
            for (int q = 0; q < E; ++q) s = s + tmp[q] * at(equu, E * M * M, t, (q * M + i) * M + j);
          for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vfu[o][j];
          if constexpr (SO)
            for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fuu, N * M * M, t, (o * M + i) * M + j);
          Lc[i][j] = s;
        }
      }
      S Qux[M][N];
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j < N; ++j) {
          S s = at(lux, M * N, t, i * N + j);
          for (int q = 0; q < E; ++q) s = s + at(equ, E * M, t, q * M + i) * tmp2[q][j];
          if constexpr (SO)
            for (int q = 0; q < E; ++q) s = s + tmp[q] * at(equx, E * M * N, t, (q * M + i) * N + j);
          for (int o = 0; o < N; ++o) s = s + at(fu, N * M, t, o * M + i) * Vfx[o][j];
          if constexpr (SO)
            for (int o = 0; o < N; ++o) s = s + Vx[o] * at(fux, N * M * N, t, (o * M + i) * N + j);
          Qux[i][j] = s;
        }
      }
      // Cholesky–Banachiewicz of Quu + reg·I (lower triangle of Lc)
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j <= i; ++j) {
          S s = Lc[i][j] + (i == j ? reg : S(0));
          for (int q = 0; q < j; ++q) s = s - Lc[i][q] * Lc[j][q];
          Lc[i][j] = (i == j) ? root(s) : s / Lc[j][j];
        }
      }
      for (int i = 0; i < M; ++i) ok = ok && positive_finite(Lc[i][i]);
      // X[c] with c = 0 ↔ Qu, c = 1 + j ↔ Qux[:, j]
      S X[1 + N][M];
      for (int c = 0; c <= N; ++c) {
        for (int i = 0; i < M; ++i) {
          S s = (c == 0) ? Qu[i] : Qux[i][c - 1];
          for (int q = 0; q < i; ++q) s = s - Lc[i][q] * X[c][q];
          X[c][i] = s / Lc[i][i];
        }
        for (int i = M - 1; i >= 0; --i) {
          S s = X[c][i];
          for (int q = i + 1; q < M; ++q) s = s - Lc[q][i] * X[c][q];
          X[c][i] = s / Lc[i][i];
        }
      }
      for (int i = 0; i < M; ++i) {
        put_k(t, i, -X[0][i]);
        for (int j = 0; j < N; ++j) put_K(t, i, j, -X[1 + j][i]);
      }
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
  }
  ok_s[lvl][threadIdx.x] = ok;
  __syncthreads();
  if (!active) return;
  int chosen = 0;
  bool any = false;
  for (int l = 0; l < L; ++l) {
    if (ok_s[l][threadIdx.x]) {
      chosen = l;
      any = true;
      break;
    }
  }
  if (lvl != chosen) return;
  a.ok_out[b] = any;
  a.reg_out[b] = a.levels[lvl * Bs + b];
  if (direct) return;
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < M; ++i) {
      a.k_out[(static_cast<size_t>(b) * T + t) * M + i] =
          a.ks[((static_cast<size_t>(lvl) * T + t) * M + i) * Bs + b];
      for (int j = 0; j < N; ++j)
        a.K_out[((static_cast<size_t>(b) * T + t) * M + i) * N + j] =
            a.Ks[((static_cast<size_t>(lvl) * T + t) * M * N + i * N + j) * Bs + b];
    }
  }
}

// ------------------------------------------------------------ launch

// One library serves one shape and order, both value types: kernels/_build.py
// compiles this file with -DDDP_N=n -DDDP_M=m -DDDP_E=e -DDDP_SO=0|1 for the
// shape of the call (the CUDA counterpart of Pallas specialising at trace
// time), so the template parameters below are compile-time constants.
#if !defined(DDP_N) || !defined(DDP_M) || !defined(DDP_E) || !defined(DDP_SO)
#error "build with -DDDP_N=<n> -DDDP_M=<m> -DDDP_E=<e> -DDDP_SO=<0|1> (kernels/_build.py)"
#endif
static_assert(DDP_N >= 1 && DDP_M >= 1 && DDP_E >= 1, "n, m and e are at least 1");
// the large-dims program solves the 1 + n right-hand sides one a lane of a
// warp, and a column of the Cholesky below its pivot one row a lane
static_assert(DDP_N < 12 || (DDP_N <= 31 && DDP_M <= 32),
              "the large-dims program takes n <= 31 and m <= 32");

// extra return codes beside cudaGetLastError()'s
constexpr int kNoInstantiation = -1;
constexpr int kTooManyLevels = -2;
constexpr int kSharedMemory = -3;

template <typename S, int N, int M, int E, bool SO>
int launch(const Args<S>& a, cudaStream_t stream) {
  if (a.L < 1 || a.L > kMaxLevels) return kTooManyLevels;
  if constexpr (N >= 12) {
    const size_t bytes = Layout<N, M, E, SO>::bytes(a.L, sizeof(S));
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes > static_cast<size_t>(optin)) return kSharedMemory;
    auto* kernel = ladder_large_kernel<S, N, M, E, SO>;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<a.B, 32 * a.L, bytes, stream>>>(a);
  } else {
    ladder_small_kernel<S, N, M, E, SO><<<(a.B + 31) / 32, dim3(32, a.L), 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int run(int second_order, int T, int B, int L,
        const void* const* in, void* ks, void* Ks, void* k, void* K, void* ok,
        void* reg_used, void* stream) {
  Args<S> a;
  for (int i = 0; i < N_FIELDS; ++i)
    a.in[i] = (i < FXX || second_order) ? static_cast<const S*>(in[i]) : nullptr;
  a.mu = static_cast<const S*>(in[N_FIELDS]);
  a.levels = static_cast<const S*>(in[N_FIELDS + 1]);
  a.lfx = static_cast<const S*>(in[N_FIELDS + 2]);
  a.lfxx = static_cast<const S*>(in[N_FIELDS + 3]);
  a.ks = static_cast<S*>(ks);
  a.Ks = static_cast<S*>(Ks);
  a.k_out = static_cast<S*>(k);
  a.K_out = static_cast<S*>(K);
  a.ok_out = static_cast<bool*>(ok);
  a.reg_out = static_cast<S*>(reg_used);
  a.T = T;
  a.B = B;
  a.L = L;
  return launch<S, DDP_N, DDP_M, DDP_E, DDP_SO != 0>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``in`` points at 22 device
// pointers in the order lx, lu, lxx, lux, luu, fx, fu, eq, eqx, equ, pe, pex,
// fxx, fux, fuu, eqxx, equx, equu (the last six only read with
// ``second_order``), then mu [B], levels [L, B], lfx [B, n], lfxx [B, n*n].
// The per-step inputs are batch-major [B, T, rows].  ``ks``/``Ks`` are per-level scratch of
// L*B*T*m and L*B*T*m*n values (unread when L == 1); k [B, T, m],
// K [B, T, m, n], ok [B], reg_used [B] are written.  Returns
// cudaGetLastError() after the launch, -1 for dims or an order other than
// the ones this library was built for, -2 for L outside 1..16, -3 for more shared memory
// than a block of this card can have.
extern "C" int ddp_riccati_ladder(int is_double, int second_order, int n, int m,
                                  int e, int T, int B, int L,
                                  const void* const* in, void* ks, void* Ks,
                                  void* k, void* K, void* ok, void* reg_used,
                                  void* stream) {
  if (n != DDP_N || m != DDP_M || e != DDP_E || (second_order != 0) != (DDP_SO != 0))
    return kNoInstantiation;  // a wrong library: the wrapper loads one per shape
  if (B <= 0 || T <= 0) return 0;  // an empty grid is not a valid launch
  return is_double ? run<double>(second_order, T, B, L, in, ks, Ks, k, K, ok, reg_used, stream)
                   : run<float>(second_order, T, B, L, in, ks, Ks, k, K, ok, reg_used, stream);
}
