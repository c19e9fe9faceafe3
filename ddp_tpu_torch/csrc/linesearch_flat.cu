// Fused line search of the batched AL-DDP solver for flat-lane problems, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/linesearch_flat.py
// (_ls_kernel, launched by linesearch_pallas's pl.pallas_call) on the
// forward="kernel" path of ddp_tpu_torch.solver.batched.solve_batched.
//
// One launch does the whole line search of one solver iteration.  For every
// lane, candidate c < C rolls the closed loop
//     u_t = us_t + step_c k_t + K_t (x_t - xs_t),   x_{t+1} = f(x_t, u_t)
// out at step_c = 2^-c and sums the augmented-Lagrangian cost
//     l(x_t, u_t) + p_t(x_t) eq_t + (mu/2) |eq_t|^2,   p_t = pe_t + pex_t (x_t - xs_t)
// plus the terminal cost; one more row rolls out at step 0, which follows the
// stored trajectory, and its cost is the incumbent's.  The lane takes the
// largest step whose cost did not rise against that row; the thread that owns
// the chosen candidate rolls out once more and writes (xs, us); a lane where
// every candidate raised the cost gets its inputs copied, bit for bit, and
// step 0.  The dynamics, the cost and the constraint are the device functions
// of the problem class (flat_problem.cuh).
//
// Layout and threads: every per-step array is [T, rows, B], the batch last.
// A block is (32 lanes) x (C + 1 rows): threadIdx.x is the lane, so each load
// of a [T, rows, B] array is coalesced over a warp, and threadIdx.y the
// candidate, so a lane's acceptance is an exchange of C + 1 costs through
// shared memory.  The TPU version's (8 candidates on sublanes) x (128 lanes)
// tile, its limit of 7 candidates and its padded zero-width blocks are not
// carried over: C is a run-time argument (at most 31, the block's 1024
// threads), and E = 0 is an instantiation that reads no multiplier array.
//
// Order of the cost sum (it decides ties in the acceptance test, so the plain
// version in kernels/linesearch_flat.py keeps the same one): per step
//     c_t = l;  for each row a:  c_t = (c_t + p_a ce_a) + ((0.5 mu) ce_a) ce_a
// then  cost = cost + c_t  for t = 0 .. T-1 in turn, then  cost + lf(x_T).
//
// Bound: at the headline (T = 32, B = 4096, C = 4, float) the inputs and
// outputs are about 3.4 MB, a microsecond at the card's 3.35 TB/s, and the
// arithmetic is (C + 2) x T steps of some forty operations and one sine per
// lane.  Neither is what a launch pays: each thread runs a serial chain of
// T dependent steps twice, so the kernel is bound by that chain's latency.
//
// Build without --use_fast_math: sinf/sin in their IEEE forms.

#include <cuda_runtime.h>

#include <cstddef>

#include "flat_problem.cuh"

namespace {

constexpr int LANES = 32;      // lanes per block (threadIdx.x)
constexpr int MAX_ROWS = 32;   // candidates + the step-0 row (threadIdx.y)

template <typename S>
struct LsArgs {
  const S* xs;    // [T+1, NX, B]
  const S* us;    // [T, M, B]
  const S* k;     // [T, M, B]
  const S* K;     // [T, M*NX, B]
  const S* pe;    // [T, E, B]
  const S* pex;   // [T, E*NX, B]
  const S* mask;  // [T, E]
  const S* mu;    // [B]
  S* xs_out;      // [T+1, NX, B]
  S* us_out;      // [T, M, B]
  S* step_out;    // [B]
  int T, B, n_cand;
};

// One closed-loop rollout of lane b at `step`.  WRITE = false returns the
// AL cost and stores nothing; WRITE = true stores the trajectory and the
// controls and returns 0.
template <typename S, typename P, int E, bool WRITE>
__device__ S rollout(const P& prob, const LsArgs<S>& a, int b, S step, S mu) {
  constexpr int NX = P::NX, M = P::M;
  const size_t Bs = static_cast<size_t>(a.B);
  auto at = [&](const S* p, int rows, int t, int r) -> S {
    return p[(static_cast<size_t>(t) * rows + r) * Bs + b];
  };
  S x[NX];
  for (int i = 0; i < NX; ++i) {
    x[i] = at(a.xs, NX, 0, i);
    if (WRITE) a.xs_out[static_cast<size_t>(i) * Bs + b] = x[i];
  }
  S cost = S(0);
#pragma unroll 1
  for (int t = 0; t < a.T; ++t) {
    S dx[NX], u[M];
    for (int j = 0; j < NX; ++j) dx[j] = x[j] - at(a.xs, NX, t, j);
    for (int i = 0; i < M; ++i) {
      S s = at(a.us, M, t, i) + step * at(a.k, M, t, i);
      for (int j = 0; j < NX; ++j) s = s + at(a.K, M * NX, t, i * NX + j) * dx[j];
      u[i] = s;
      if (WRITE) a.us_out[(static_cast<size_t>(t) * M + i) * Bs + b] = s;
    }
    if (!WRITE) {
      S ct = prob.stage(x, u);
      if constexpr (E > 0) {
        bool any = false;
        for (int r = 0; r < E; ++r) any = any || a.mask[t * E + r] != S(0);
        if (any) {
          S ce[E];
          prob.eq(x, u, ce);
          for (int r = 0; r < E; ++r) {
            const S cea = ce[r] * a.mask[t * E + r];
            S p = at(a.pe, E, t, r);
            for (int j = 0; j < NX; ++j) p = p + at(a.pex, E * NX, t, r * NX + j) * dx[j];
            ct = ct + p * cea + S(0.5) * mu * cea * cea;
          }
        }
      }
      cost = cost + ct;
    }
    S xn[NX];
    prob.dynamics(x, u, xn);
    for (int i = 0; i < NX; ++i) {
      x[i] = xn[i];
      if (WRITE) a.xs_out[(static_cast<size_t>(t + 1) * NX + i) * Bs + b] = xn[i];
    }
  }
  if (!WRITE) cost = cost + prob.terminal(x);
  return cost;
}

template <typename S, typename P, int E>
__global__ void __launch_bounds__(LANES * MAX_ROWS) linesearch_flat_kernel(
    LsArgs<S> a, const S* __restrict__ consts, int advance) {
  static_assert(E == 0 || E == P::NE, "constraint rows of the problem class");
  constexpr int NX = P::NX, M = P::M;
  __shared__ S costs[MAX_ROWS][LANES];
  const int lane = threadIdx.x, c = threadIdx.y, C = a.n_cand;
  const int b = blockIdx.x * LANES + lane;
  const bool live = b < a.B;
  const P prob(consts, advance);
  // the step ladder 1, 1/2, ..., 2^-(C-1); row C carries step 0
  const S step = c < C ? S(1) / S(1u << c) : S(0);
  const S mu = live ? a.mu[b] : S(0);
  costs[c][lane] = live ? rollout<S, P, E, false>(prob, a, b, step, mu) : S(0);
  __syncthreads();
  if (!live) return;

  const S cost0 = costs[C][lane];
  int chosen = -1;  // first accepted = largest accepted step
  for (int r = C - 1; r >= 0; --r)
    if (costs[r][lane] - cost0 <= S(0)) chosen = r;
  const size_t Bs = static_cast<size_t>(a.B);
  if (chosen < 0) {
    if (c != C) return;
    // no candidate accepted: the stored trajectory, bit for bit
    for (int i = 0; i < (a.T + 1) * NX; ++i) a.xs_out[i * Bs + b] = a.xs[i * Bs + b];
    for (int i = 0; i < a.T * M; ++i) a.us_out[i * Bs + b] = a.us[i * Bs + b];
    a.step_out[b] = S(0);
  } else if (c == chosen) {
    rollout<S, P, E, true>(prob, a, b, step, mu);
    a.step_out[b] = step;
  }
}

template <typename S, typename P, int E>
int launch(const void* const* p, const void* consts, int advance, int T, int B,
           int n_cand, cudaStream_t stream) {
  LsArgs<S> a;
  a.xs = static_cast<const S*>(p[0]);
  a.us = static_cast<const S*>(p[1]);
  a.k = static_cast<const S*>(p[2]);
  a.K = static_cast<const S*>(p[3]);
  a.pe = static_cast<const S*>(p[4]);
  a.pex = static_cast<const S*>(p[5]);
  a.mask = static_cast<const S*>(p[6]);
  a.mu = static_cast<const S*>(p[7]);
  a.xs_out = static_cast<S*>(const_cast<void*>(p[8]));
  a.us_out = static_cast<S*>(const_cast<void*>(p[9]));
  a.step_out = static_cast<S*>(const_cast<void*>(p[10]));
  a.T = T;
  a.B = B;
  a.n_cand = n_cand;
  const dim3 block(LANES, n_cand + 1);
  const int blocks = (B + LANES - 1) / LANES;
  linesearch_flat_kernel<S, P, E><<<blocks, block, 0, stream>>>(
      a, static_cast<const S*>(consts), advance);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_class(int class_id, int nx, int m, int e, const void* const* p,
                 const void* consts, int advance, int T, int B, int n_cand,
                 cudaStream_t s) {
  if (class_id == 0 && nx == 2 && m == 1) {
    using P = PendulumEulerTarget<S>;
    if (e == 1) return launch<S, P, 1>(p, consts, advance, T, B, n_cand, s);
    if (e == 0) return launch<S, P, 0>(p, consts, advance, T, B, n_cand, s);
  }
  return -1;
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``ptrs`` points at 11 device
// pointers in the order xs, us, k, K, pe, pex, mask, mu, xs_out, us_out,
// step_out (pe, pex, mask are not read when e == 0); ``consts`` is the
// problem class's constant buffer.  Returns cudaGetLastError() after the
// launch; -1 for a class, dims or a candidate count this build does not take.
extern "C" int ddp_linesearch_flat(int is_double, int class_id, int nx, int m,
                                   int e, int T, int B, int n_cand, int advance,
                                   const void* const* ptrs, const void* consts,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;  // an empty grid is not a valid launch
  if (n_cand < 1 || n_cand + 1 > MAX_ROWS) return -1;
  return is_double
             ? launch_class<double>(class_id, nx, m, e, ptrs, consts, advance, T, B, n_cand, s)
             : launch_class<float>(class_id, nx, m, e, ptrs, consts, advance, T, B, n_cand, s);
}
