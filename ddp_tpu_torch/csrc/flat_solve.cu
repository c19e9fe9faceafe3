// The whole fixed-budget batched AL-DDP solve of a flat-lane problem in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/flat_solve.py (_solve_kernel,
// launched by solve_flat_pallas's pl.pallas_call); wrapper and plain version:
// ddp_tpu_torch/kernels/flat_solve.py.
//
// Program of one lane: the initial rollout; then, before the iterations and
// in each of them, the derivatives along the trajectory and the Riccati
// reverse sweep (Gauss-Newton, AL multiplier terms, one regularization level),
// the line search (incumbent cost, n_ls closed-loop rollouts at the steps
// 2^-c, the largest step whose AL cost did not rise), the commit of the
// trajectory (only if every pivot was positive and a step was accepted) and
// of the gains; in each iteration before that the re-anchoring of multipliers
// and gains at the trajectory, both optimality adjoints, and the schedule of
// multipliers, mu, w, n and reg; at the end the final measures.  The
// constraint is active at one step `ta`: its E rows' value and Jacobian are
// evaluated there (with ta as the time index, masked by the rows' mask at
// ta) once per iteration and enter the sweeps behind t == ta; the terminal
// cost's gradient and Hessian start the sweeps and the adjoints.  Derivatives
// come from the problem class's device functions (flat_problem.cuh) in Dual
// numbers (cost gradient, dynamics and constraint Jacobians) and HyperDual
// numbers (cost Hessian), as forward-mode differentiation does in the TPU
// kernel.
//
// What bounds it on this card: not bytes (inputs and outputs are 1.6 MB at
// the headline) and not the arithmetic rate, but the length of a lane's
// dependent chain, the latency of each link, and how many chains run at once.
// A lane is a group of G threads, G the power of two at least n_ls + 1
// (G = 8 at 4 candidates), LPB lanes a block (32 where the shared memory
// allows): thread r * LPB + l is role r of lane l, so with 32 lanes a block
// every warp holds one role of 32 lanes and the roles run side by side
// without diverging.  Independent work runs on separate roles: the per-step
// derivatives and the re-anchoring spread over t across the group; the two
// optimality adjoints on roles 0 and 1; the Riccati recursion (sequential in
// t) on role 0 while role 1 sums the incumbent's AL cost; the n_ls candidate
// rollouts on roles 0 .. n_ls - 1, each keeping its trajectory, so the
// accepted one is copied, not rolled out again; the commit spread over t.
// A lane's chain is about 3 x T step evaluations a pass.
//
// At T = 32 the chain bounds it: the whole working set of 32 lanes fits one
// block, B = 4096 lanes are 128 blocks on 132 SMs, one wave.  At T >= 100 the
// working set bounds it too: it grows with T (the per-step derivatives, the
// candidates' rollouts, the multipliers, the gains and their anchors), so
// fewer lanes fit a block and the same chain runs in several waves.  Hence two
// programs, one source, picked per launch by flat_solve_plan:
//   - resident (STREAM = false): the lane's whole working set in shared
//     memory, element i of lane l at i * LPB + l, conflict-free; global
//     memory read once at the start and written once at the end;
//   - streamed (STREAM = true): shared memory keeps only what a chain reads
//     at every step, the trajectory, the controls and the new gains (6T + 2
//     scalars a lane with the terminal derivatives, for the pendulum), and
//     two rings of ring_depth steps.  Everything else lives in a global
//     scratch [rows, lanes], lanes on the fast axis so a warp's accesses
//     coalesce: the derivatives of each step (lz, fz, the upper triangle of
//     lzz), written by the parallel derivative pass; the multipliers, the
//     gains and their anchors; the candidates' rollouts, written by their
//     chains without waiting.  The reverse sweeps (the backward on role 0,
//     the adjoints on roles 0 and 1) read a step's derivatives and
//     multipliers from the role's ring, filled ring_depth - 1 steps ahead
//     with asynchronous copies (cp.async), so the L2's latency stays off the
//     chain.  The commit reads the accepted rollout and, with the same
//     loads, re-anchors the multipliers and gains for the next pass (the
//     resident program does that at the start of the pass, from shared
//     memory): one round trip to the scratch a step, where loads spread over
//     two passes and ordered behind stores took several.
// The plan takes the program with fewer waves at the launch's B (blocks an
// SM from the card's occupancy of each instantiation: shared memory, threads
// and registers), the resident one on a tie (its chain is shorter: on an H100
// at the arrive-at-rest fleet's class, T = 100 and B = 1024, one wave each,
// 2.98-3.00 ms against 3.64-3.67, examples/torch_flat_solve_ab.py).  At the
// f32 headline the streamed program would take 0.34 ms against 0.24.  The
// plan is its own entry point (ddp_flat_solve_plan), which also gives the
// scratch's rows and stride: the wrapper asks once per class, T, B, n_ls,
// type and card, and allocates a scratch only for the streamed program.
// Every sum within a lane keeps the first design's and the plain version's
// order (the AL cost over t, the adjoints, the candidates' ladder scan), so
// the gates see the same inputs; the two programs differ only in where an
// array lives and when the re-anchoring runs.  The time loops stay loops (#pragma unroll
// 1): T, the iteration budget, the candidate count, ta, the method and every
// threshold are run-time arguments; the scalar type and the problem class's
// integrator, cost kind and row count E are compiled in: a library serves one
// class, its -DDDP_DYN, -DDDP_COST and -DDDP_E from kernels/_build.py::load
// (flat_problem.cuh says what is compiled in and what is data).
//
// A failed factorization gives NaN gains through sqrt of a negative pivot and
// ok = false for the lane, which then keeps its trajectory and escalates its
// reg: build without --use_fast_math and without -ftz.  The caps on mu and
// the multipliers and the adjoints' largest residual keep a NaN as NaN, as
// the plain version and ddp_tpu do, so a lane that went NaN reports NaN.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "flat_problem.cuh"

namespace {

__device__ __forceinline__ float power(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double power(double x, double y) { return pow(x, y); }

// x > 0 && isfinite(x): false for NaN (every comparison is) and for +inf
template <typename S>
__device__ __forceinline__ bool positive_finite(S x) {
  return x > S(0) && x < S(INFINITY);
}

// lz [NZ] and fz [NX][NZ] at (x, u): one Dual evaluation per direction of z
template <typename S, typename P>
__device__ __forceinline__ void first_derivs(const P& prob, const S* x, const S* u, S* lz,
                                             S (*fz)[P::NX + P::M]) {
  constexpr int NX = P::NX, M = P::M, NZ = NX + M;
  using D = Dual<S>;
  for (int j = 0; j < NZ; ++j) {
    D xd[NX], ud[M], xn[NX];
    for (int i = 0; i < NX; ++i) xd[i] = D(x[i], i == j ? S(1) : S(0));
    for (int i = 0; i < M; ++i) ud[i] = D(u[i], NX + i == j ? S(1) : S(0));
    lz[j] = prob.stage(xd, ud).t;
    prob.dynamics(xd, ud, xn);
    for (int o = 0; o < NX; ++o) fz[o][j] = xn[o].t;
  }
}

// lzz [NZ][NZ] at (x, u): one HyperDual evaluation per pair i <= j
template <typename S, typename P>
__device__ __forceinline__ void cost_hessian(const P& prob, const S* x, const S* u,
                                             S (*lzz)[P::NX + P::M]) {
  constexpr int NX = P::NX, M = P::M, NZ = NX + M;
  using H = HyperDual<S>;
  for (int i = 0; i < NZ; ++i) {
    for (int j = i; j < NZ; ++j) {
      H xh[NX], uh[M];
      for (int r = 0; r < NX; ++r)
        xh[r] = H(x[r], r == i ? S(1) : S(0), r == j ? S(1) : S(0), S(0));
      for (int r = 0; r < M; ++r)
        uh[r] = H(u[r], NX + r == i ? S(1) : S(0), NX + r == j ? S(1) : S(0), S(0));
      const S h = prob.stage(xh, uh).h;
      lzz[i][j] = h;
      lzz[j][i] = h;
    }
  }
}

// terminal cost gradient and Hessian at x
template <typename S, typename P>
__device__ __forceinline__ void terminal_derivs(const P& prob, const S* x, S* lfx,
                                                S (*lfxx)[P::NX]) {
  constexpr int NX = P::NX;
  using H = HyperDual<S>;
  for (int i = 0; i < NX; ++i) {
    for (int j = i; j < NX; ++j) {
      H xh[NX];
      for (int r = 0; r < NX; ++r)
        xh[r] = H(x[r], r == i ? S(1) : S(0), r == j ? S(1) : S(0), S(0));
      const H v = prob.terminal(xh);
      lfxx[i][j] = v.h;
      lfxx[j][i] = v.h;
      if (j == i) lfx[i] = v.t1;
    }
  }
}

// the clip and the larger of two as torch.clamp, jnp.clip and torch.maximum
// take them: a NaN stays NaN (fmin and fmax would return the other operand)
template <typename S>
__device__ __forceinline__ S clip(S x, S lo, S hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
template <typename S>
__device__ __forceinline__ S maximum(S x, S y) {
  return (y > x || y != y) ? y : x;
}

template <typename S>
struct SolveArgs {
  // inputs
  const S* x0;      // [NX, B]
  const S* us0;     // [T, M, B]
  const S* scal;    // [4, B]: mu, reg, w, n
  const S* consts;  // the problem class's constants
  const S* mrow;    // [E] 0/1 mask of the constraint rows at ta
  // outputs
  S* us;     // [T, M, B]
  S* xs;     // [T+1, NX, B]
  S* fbk;    // [T, M, B]
  S* fbK;    // [T, M*NX, B]
  S* stats;  // [6, B]: opt_constr, opt_lag, mu, reg, w, n
  S* mval;   // [T, E, B]
  S* mjac;   // [T, E*NX, B]
  // the streamed program's working storage: [ScratchLayout rows, stride],
  // column blockIdx.x * LPB + slot (padded lanes have their own)
  S* scratch;
  size_t stride;
  int T, B, n_iters, n_ls, ta, affine, primal, has_mu_max, has_mult_max;
  int inner_max;  // -1: none
  int G, LPB;     // the launch plan: threads a lane, lanes a block
  S threshold, w_min, mu_factor, mu_max, mult_max;
};

// the lane's scalars in shared memory, after its arrays
constexpr int LANE_OK = 0, LANE_COST_OLD = 1, LANE_OO = 2, LANE_OLAG = 3, LANE_ACC = 4;
// steps a streamed reverse sweep keeps in its ring, ring_depth - 1 of them
// in flight: deeper in float, where a step's chain is shorter, than in double
__host__ __device__ constexpr int ring_depth(int item) { return item == 4 ? 8 : 4; }

// A streamed step's row: its derivatives (lz, fz, the upper triangle of lzz)
// and, in a ring, its multipliers (pe, pex) after them.
__host__ __device__ constexpr int deriv_rows(int nx, int m) {
  return (nx + m) * (1 + nx) + (nx + m) * (nx + m + 1) / 2;
}
__host__ __device__ constexpr int ring_rows(int nx, int m, int e) {
  return deriv_rows(nx, m) + e * (1 + nx);
}

// Offsets of one lane's arrays in shared memory, in scalars: the resident
// program's whole working set, or the streamed program's trajectory,
// controls, gains, terminal derivatives and the rings of roles 0 and 1, in a
// type of `item` bytes.
struct LaneLayout {
  int xs, us, k, K, fbk, fbK, mval, mjac, morig, fborig, lz, lzz, fz, lfx, lfxx, xc, uc, ring, flags;
  int total;
  __host__ __device__ LaneLayout(int T, int nx, int m, int e, int n_ls, bool stream, int item) {
    const int nz = nx + m;
    int o = 0;
    xs = o, o += (T + 1) * nx;
    us = o, o += T * m;
    k = o, o += T * m;
    K = o, o += T * m * nx;
    fbk = fbK = mval = mjac = morig = fborig = lz = lzz = fz = xc = uc = ring = 0;
    if (!stream) {
      fbk = o, o += T * m;
      fbK = o, o += T * m * nx;
      mval = o, o += T * e;
      mjac = o, o += T * e * nx;
      morig = o, o += T * nx;
      fborig = o, o += T * nx;
      lz = o, o += T * nz;
      lzz = o, o += T * nz * nz;
      fz = o, o += T * nx * nz;
    }
    lfx = o, o += nx;
    lfxx = o, o += nx * nx;
    if (!stream) {
      xc = o, o += n_ls * (T + 1) * nx;
      uc = o, o += n_ls * T * m;
    } else {
      ring = o, o += 2 * ring_depth(item) * ring_rows(nx, m, e);
    }
    flags = o, o += LANE_ACC + n_ls;
    total = o;
  }
};

// Rows of one lane's columns in the streamed program's global scratch.
struct ScratchLayout {
  int d, fbk, fbK, mval, mjac, morig, fborig, xc, uc, total;
  __host__ __device__ ScratchLayout(int T, int nx, int m, int e, int n_ls) {
    int o = 0;
    d = o, o += T * deriv_rows(nx, m);
    fbk = o, o += T * m;
    fbK = o, o += T * m * nx;
    mval = o, o += T * e;
    mjac = o, o += T * e * nx;
    morig = o, o += T * nx;
    fborig = o, o += T * nx;
    xc = o, o += n_ls * (T + 1) * nx;
    uc = o, o += n_ls * T * m;
    total = o;
  }
};

constexpr int kMaxThreads = 256;   // a block, the kernel's launch bound
constexpr int kMaxLanes = 32;      // a block: one warp holds one role
constexpr long kMaxSmem = 232448;  // dynamic shared memory a block may opt in to (sm_90)

// The launch plan: G threads a lane, LPB lanes a block, the program (0
// resident, 1 streamed), blocks an SM can hold, blocks, waves over the card's
// SMs, and the block's shared-memory bytes.
struct FlatSolvePlan {
  int G, LPB, stream, per_sm, blocks, waves;
  long smem;
};

// The plan of (T, nx, m, e, n_ls) over B lanes in a type of `item` bytes on
// `sms` SMs.  G is the power of two at least n_ls + 1; each program takes the
// largest power of two of lanes a block (at most kMaxLanes, G * LPB at most
// kMaxThreads) whose lanes fit the shared memory, and `occupancy(stream,
// threads, smem)` says how many such blocks an SM holds.  The program with
// fewer waves wins, the resident one on a tie; `program` (0 or 1; -1:
// either) takes that program alone.  Returns false when neither fits one lane.
template <typename Occupancy>
inline bool flat_solve_plan(int T, int nx, int m, int e, int n_ls, int item, int B, int sms,
                            int program, Occupancy occupancy, FlatSolvePlan* plan) {
  int g = 2;
  while (g < n_ls + 1) g *= 2;
  bool found = false;
  for (int stream = 0; stream < 2; ++stream) {
    if (program >= 0 && program != stream) continue;
    const long lane = static_cast<long>(LaneLayout(T, nx, m, e, n_ls, stream != 0, item).total) * item;
    int lpb = kMaxThreads / g < kMaxLanes ? kMaxThreads / g : kMaxLanes;
    while (lpb >= 1 && lane * lpb > kMaxSmem) lpb /= 2;
    if (lpb < 1) continue;
    const int per_sm = occupancy(stream, g * lpb, lane * lpb);
    if (per_sm < 1) continue;
    const int blocks = (B + lpb - 1) / lpb;
    const long slots = static_cast<long>(sms) * per_sm;
    const int waves = static_cast<int>((blocks + slots - 1) / slots);
    if (!found || waves < plan->waves) {
      *plan = FlatSolvePlan{g, lpb, stream, per_sm, blocks, waves, lane * lpb};
      found = true;
    }
  }
  return found;
}

// One block an SM is the least the plan needs: with that minimum stated,
// ptxas gives the double instantiations the registers they use instead of
// capping them at 128 and spilling.
template <typename S, typename P, bool STREAM>
__global__ void __launch_bounds__(kMaxThreads, 1) flat_solve_kernel(SolveArgs<S> a) {
  constexpr int NX = P::NX, M = P::M, NZ = NX + M, E = P::NE;
  constexpr int EK = E > 0 ? E : 1;  // array extents; loops run to E
  constexpr int DR = deriv_rows(NX, M), RR = ring_rows(NX, M, E), kRing = ring_depth(sizeof(S));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const sm = reinterpret_cast<S*>(smem_raw);
  const int G = a.G, LPB = a.LPB;
  const int slot = threadIdx.x % LPB, role = threadIdx.x / LPB;
  // a slot past the batch's edge repeats the last lane and writes nothing
  // but its own scratch column
  const int lane = static_cast<int>(blockIdx.x) * LPB + slot;
  const bool live = lane < a.B;
  const int b = live ? lane : a.B - 1;
  const size_t Bs = static_cast<size_t>(a.B);
  const int T = a.T, ta = a.ta, n_ls = a.n_ls;
  const P prob(a.consts);
  const LaneLayout lay(T, NX, M, E, n_ls, STREAM, sizeof(S));
  const ScratchLayout sl(T, NX, M, E, n_ls);
  // element i of this lane's shared arrays
  auto at = [&](int i) -> S& { return sm[static_cast<size_t>(i) * LPB + slot]; };
  // row i of this lane's scratch column (streamed)
  auto gs = [&](int i) -> S& { return a.scratch[static_cast<size_t>(i) * a.stride + lane]; };
  // element (t, r) of a [T, rows, B] global array, this lane
  auto ix = [&](int t, int rows, int r) -> size_t {
    return (static_cast<size_t>(t) * rows + r) * Bs + b;
  };
  // the arrays of both programs: in shared memory, or those the streamed
  // program keeps in its scratch
  auto X = [&](int t, int i) -> S& { return at(lay.xs + t * NX + i); };
  auto U = [&](int t, int j) -> S& { return at(lay.us + t * M + j); };
  auto Kf = [&](int t, int j) -> S& { return at(lay.k + t * M + j); };
  auto KK = [&](int t, int j, int i) -> S& { return at(lay.K + (t * M + j) * NX + i); };
  auto FBk = [&](int t, int j) -> S& {
    if constexpr (STREAM) return gs(sl.fbk + t * M + j);
    else return at(lay.fbk + t * M + j);
  };
  auto FBK = [&](int t, int j, int i) -> S& {
    if constexpr (STREAM) return gs(sl.fbK + (t * M + j) * NX + i);
    else return at(lay.fbK + (t * M + j) * NX + i);
  };
  auto MV = [&](int t, int r) -> S& {
    if constexpr (STREAM) return gs(sl.mval + t * E + r);
    else return at(lay.mval + t * E + r);
  };
  auto MJ = [&](int t, int r, int i) -> S& {
    if constexpr (STREAM) return gs(sl.mjac + (t * E + r) * NX + i);
    else return at(lay.mjac + (t * E + r) * NX + i);
  };
  auto MO = [&](int t, int i) -> S& {
    if constexpr (STREAM) return gs(sl.morig + t * NX + i);
    else return at(lay.morig + t * NX + i);
  };
  auto FO = [&](int t, int i) -> S& {
    if constexpr (STREAM) return gs(sl.fborig + t * NX + i);
    else return at(lay.fborig + t * NX + i);
  };
  auto XC = [&](int c, int t, int i) -> S& {
    if constexpr (STREAM) return gs(sl.xc + (c * (T + 1) + t) * NX + i);
    else return at(lay.xc + (c * (T + 1) + t) * NX + i);
  };
  auto UC = [&](int c, int t, int j) -> S& {
    if constexpr (STREAM) return gs(sl.uc + (c * T + t) * M + j);
    else return at(lay.uc + (c * T + t) * M + j);
  };
  auto flag = [&](int f) -> S& { return at(lay.flags + f); };

  const bool constrained = E > 0 && ta >= 0;
  S mrow[EK];
  for (int r = 0; r < E; ++r) mrow[r] = a.mrow[r];
  // the constraint's masked value and Jacobian at the active step, in every
  // thread of the lane
  S eqr_v[EK], eqr_z[EK][NZ];
  for (int r = 0; r < EK; ++r) {
    eqr_v[r] = S(0);
    for (int j = 0; j < NZ; ++j) eqr_z[r][j] = S(0);
  }

  // ---------------- inputs, zero multipliers and gains, initial rollout ------
#pragma unroll 1
  for (int t = role; t < T; t += G) {
    for (int j = 0; j < M; ++j) {
      U(t, j) = a.us0[ix(t, M, j)];
      FBk(t, j) = S(0);
      for (int i = 0; i < NX; ++i) FBK(t, j, i) = S(0);
    }
    for (int r = 0; r < E; ++r) {
      MV(t, r) = S(0);
      for (int i = 0; i < NX; ++i) MJ(t, r, i) = S(0);
    }
  }
  if (role == 0)
    for (int i = 0; i < NX; ++i) X(0, i) = a.x0[i * Bs + b];
  __syncthreads();
  if (role == 0) {
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S x[NX], u[M], xn[NX];
      for (int i = 0; i < NX; ++i) x[i] = X(t, i);
      for (int j = 0; j < M; ++j) u[j] = U(t, j);
      prob.dynamics(x, u, xn);
      for (int i = 0; i < NX; ++i) X(t + 1, i) = xn[i];
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int t = role; t < T; t += G)
    for (int i = 0; i < NX; ++i) MO(t, i) = FO(t, i) = X(t, i);

  S mu = a.scal[b], reg = a.scal[Bs + b], w = a.scal[2 * Bs + b], n_tol = a.scal[3 * Bs + b];
  S oo_prev = S(INFINITY);
  bool just_changed = true;
  int inner = 1;  // the pre-loop backward/forward already ran

  // ---------------- stages ---------------------------------------------------
  auto load_xu = [&](int t, S* x, S* u) {
    for (int i = 0; i < NX; ++i) x[i] = X(t, i);
    for (int j = 0; j < M; ++j) u[j] = U(t, j);
  };

  // constraint value and Jacobian at the active step on the current (xs, us)
  auto hoist_eq = [&]() {
    if constexpr (E > 0) {
      if (ta < 0) return;
      S x[NX], u[M], ev[E];
      load_xu(ta, x, u);
      prob.eq(ta, x, u, ev);
      for (int r = 0; r < E; ++r) eqr_v[r] = ev[r] * mrow[r];
      for (int j = 0; j < NZ; ++j) {
        Dual<S> xd[NX], ud[M], ed[E];
        for (int i = 0; i < NX; ++i) xd[i] = Dual<S>(x[i], i == j ? S(1) : S(0));
        for (int i = 0; i < M; ++i) ud[i] = Dual<S>(u[i], NX + i == j ? S(1) : S(0));
        prob.eq(ta, xd, ud, ed);
        for (int r = 0; r < E; ++r) eqr_z[r][j] = ed[r].t * mrow[r];
      }
    }
  };

  // the hoisted rows behind t == ta
  auto eq_rows = [&](int t, S* eqv, S (*eqz)[NZ]) {
    const S sel = (constrained && t == ta) ? S(1) : S(0);
    for (int r = 0; r < E; ++r) {
      eqv[r] = eqr_v[r] * sel;
      for (int j = 0; j < NZ; ++j) eqz[r][j] = eqr_z[r][j] * sel;
    }
  };

  // the derivatives of step t along the trajectory, stored for the sweeps:
  // lz and fz, then the cost Hessian lzz (the upper triangle where streamed)
  auto store_first = [&](int t, const S* lz, const S (*fz)[NZ]) {
    for (int j = 0; j < NZ; ++j) {
      if constexpr (STREAM) gs(sl.d + t * DR + j) = lz[j];
      else at(lay.lz + t * NZ + j) = lz[j];
    }
    for (int o = 0; o < NX; ++o)
      for (int j = 0; j < NZ; ++j) {
        if constexpr (STREAM) gs(sl.d + t * DR + NZ + o * NZ + j) = fz[o][j];
        else at(lay.fz + (t * NX + o) * NZ + j) = fz[o][j];
      }
  };
  auto store_hessian = [&](int t, const S (*lzz)[NZ]) {
    if constexpr (STREAM) {
      int h = sl.d + t * DR + NZ * (1 + NX);
      for (int i = 0; i < NZ; ++i)
        for (int j = i; j < NZ; ++j) gs(h++) = lzz[i][j];
    } else {
      for (int i = 0; i < NZ; ++i)
        for (int j = 0; j < NZ; ++j) at(lay.lzz + (t * NZ + i) * NZ + j) = lzz[i][j];
    }
  };

  // streamed: step t's row (the lzz rows where `hess`) into slot t % kRing of
  // ring `rr`, one group of asynchronous copies (an empty one for t < 0)
  auto prefetch = [&](int rr, int t, bool hess) {
    if constexpr (STREAM) {
      if (t >= 0) {
        const int base = lay.ring + (rr * kRing + t % kRing) * RR;
        const int n = hess ? DR : NZ * (1 + NX);
        for (int j = 0; j < n; ++j)
          __pipeline_memcpy_async(&at(base + j), &gs(sl.d + t * DR + j), sizeof(S));
        for (int r = 0; r < E; ++r) {
          __pipeline_memcpy_async(&at(base + DR + r * (1 + NX)), &MV(t, r), sizeof(S));
          for (int i = 0; i < NX; ++i)
            __pipeline_memcpy_async(&at(base + DR + r * (1 + NX) + 1 + i), &MJ(t, r, i), sizeof(S));
        }
      }
      __pipeline_commit();
    }
  };

  // a reverse sweep from t = T - 1 on ring `rr`: the first kRing - 1 steps in
  // flight
  auto sweep_start = [&](int rr, bool hess) {
    if constexpr (STREAM)
      for (int d = 0; d < kRing - 1; ++d) prefetch(rr, T - 1 - d, hess);
  };

  // step t of a reverse sweep on ring `rr`: the stored derivatives (lzz
  // where `hess`) and the multipliers of step t
  auto step_inputs = [&](int rr, int t, bool hess, S* lz, S (*fz)[NZ], S (*lzz)[NZ], S* pe,
                         S (*pex)[NX]) {
    if constexpr (STREAM) {
      prefetch(rr, t - (kRing - 1), hess);
      __pipeline_wait_prior(kRing - 1);
      const int base = lay.ring + (rr * kRing + t % kRing) * RR;
      for (int j = 0; j < NZ; ++j) lz[j] = at(base + j);
      for (int o = 0; o < NX; ++o)
        for (int j = 0; j < NZ; ++j) fz[o][j] = at(base + NZ + o * NZ + j);
      if (hess) {
        int h = base + NZ * (1 + NX);
        for (int i = 0; i < NZ; ++i)
          for (int j = i; j < NZ; ++j) lzz[i][j] = lzz[j][i] = at(h++);
      }
      for (int r = 0; r < E; ++r) {
        pe[r] = at(base + DR + r * (1 + NX));
        for (int i = 0; i < NX; ++i) pex[r][i] = at(base + DR + r * (1 + NX) + 1 + i);
      }
    } else {
      for (int j = 0; j < NZ; ++j) lz[j] = at(lay.lz + t * NZ + j);
      for (int o = 0; o < NX; ++o)
        for (int j = 0; j < NZ; ++j) fz[o][j] = at(lay.fz + (t * NX + o) * NZ + j);
      if (hess)
        for (int i = 0; i < NZ; ++i)
          for (int j = 0; j < NZ; ++j) lzz[i][j] = at(lay.lzz + (t * NZ + i) * NZ + j);
      for (int r = 0; r < E; ++r) {
        pe[r] = MV(t, r);
        for (int i = 0; i < NX; ++i) pex[r][i] = MJ(t, r, i);
      }
    }
  };

  // the Riccati reverse sweep over the stored derivatives: writes k, K; true
  // iff every pivot of every step was positive and finite
  auto backward = [&](S mu_, S reg_) -> bool {
    S Vx[NX], Vxx[NX][NX];
    for (int i = 0; i < NX; ++i) {
      Vx[i] = at(lay.lfx + i);
      for (int j = 0; j < NX; ++j) Vxx[i][j] = at(lay.lfxx + i * NX + j);
    }
    bool ok = true;
    sweep_start(0, true);
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      S lz[NZ], lzz[NZ][NZ], fz[NX][NZ], pe[EK], pex[EK][NX];
      step_inputs(0, t, true, lz, fz, lzz, pe, pex);
      S eqv[EK], eqz[EK][NZ], tmp[EK], tmp2[EK][NX];
      eq_rows(t, eqv, eqz);
      for (int r = 0; r < E; ++r) {
        tmp[r] = pe[r] + mu_ * eqv[r];
        for (int j = 0; j < NX; ++j) tmp2[r][j] = pex[r][j] + mu_ * eqz[r][j];
      }
      S Qz[NZ];
      for (int i = 0; i < NZ; ++i) {
        S s = lz[i];
        for (int o = 0; o < NX; ++o) s = s + fz[o][i] * Vx[o];
        Qz[i] = s;
      }
      for (int r = 0; r < E; ++r) {
        for (int i = 0; i < NX; ++i) Qz[i] = Qz[i] + eqz[r][i] * tmp[r] + pex[r][i] * eqv[r];
        for (int i = 0; i < M; ++i) Qz[NX + i] = Qz[NX + i] + eqz[r][NX + i] * tmp[r];
      }
      S Vf[NX][NZ];
      for (int o = 0; o < NX; ++o) {
        for (int j = 0; j < NZ; ++j) {
          S s = Vxx[o][0] * fz[0][j];
          for (int r = 1; r < NX; ++r) s = s + Vxx[o][r] * fz[r][j];
          Vf[o][j] = s;
        }
      }
      S Qzz[NZ][NZ];
      for (int i = 0; i < NZ; ++i) {
        for (int j = 0; j < NZ; ++j) {
          S s = lzz[i][j];
          for (int o = 0; o < NX; ++o) s = s + fz[o][i] * Vf[o][j];
          Qzz[i][j] = s;
        }
      }
      for (int r = 0; r < E; ++r) {
        for (int i = 0; i < NX; ++i) {
          for (int j = 0; j < NX; ++j)
            Qzz[i][j] = Qzz[i][j] + eqz[r][i] * tmp2[r][j] + pex[r][i] * eqz[r][j];
          for (int i2 = 0; i2 < M; ++i2)
            Qzz[NX + i2][i] = Qzz[NX + i2][i] + eqz[r][NX + i2] * tmp2[r][i];
        }
        for (int i2 = 0; i2 < M; ++i2)
          for (int j2 = 0; j2 < M; ++j2)
            Qzz[NX + i2][NX + j2] =
                Qzz[NX + i2][NX + j2] + mu_ * eqz[r][NX + i2] * eqz[r][NX + j2];
      }
      // Cholesky of Quu + reg I, then the solves for Qu and the columns of Qux
      S L[M][M];
      for (int i = 0; i < M; ++i)
        for (int j = 0; j < M; ++j) L[i][j] = Qzz[NX + i][NX + j] + (i == j ? reg_ : S(0));
      chol_factor<S, M>(L);
      for (int i = 0; i < M; ++i) ok = ok && positive_finite(L[i][i]);
      S Xs[1 + NX][M];  // Xs[0] = Quu^-1 Qu, Xs[1 + j] = Quu^-1 Qux[:, j]
      for (int c = 0; c <= NX; ++c) {
        for (int i = 0; i < M; ++i) Xs[c][i] = (c == 0) ? Qz[NX + i] : Qzz[NX + i][c - 1];
        chol_apply<S, M>(L, Xs[c]);
      }
      for (int i = 0; i < M; ++i) {
        Kf(t, i) = -Xs[0][i];
        for (int j = 0; j < NX; ++j) KK(t, i, j) = -Xs[1 + j][i];
      }
      for (int i = 0; i < NX; ++i) {
        S s = Qz[i];
        for (int o = 0; o < M; ++o) s = s - Qzz[NX + o][i] * Xs[0][o];
        Vx[i] = s;
      }
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
          S s = Qzz[i][j];
          for (int o = 0; o < M; ++o) s = s - Qzz[NX + o][i] * Xs[1 + j][o];
          Vxx[i][j] = s;
        }
      }
    }
    return ok;
  };

  // one optimality measure by its reverse adjoint recursion over the stored
  // derivatives, on ring `rr`: the objective's (lag = false, the mu-weighted
  // penalty in) or the Lagrangian's
  auto adjoint = [&](int rr, bool lag, S mu_) -> S {
    S adj[NX];
    for (int i = 0; i < NX; ++i) adj[i] = at(lay.lfx + i);
    S best = S(0);
    sweep_start(rr, false);
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      S lz[NZ], fz[NX][NZ], pe[EK], pex[EK][NX];
      step_inputs(rr, t, false, lz, fz, nullptr, pe, pex);
      S eqv[EK], eqz[EK][NZ];
      eq_rows(t, eqv, eqz);
      S ss = S(0);
      for (int i = 0; i < M; ++i) {
        S vv = lz[NX + i];
        for (int r = 0; r < E; ++r)
          vv = vv + eqz[r][NX + i] * (lag ? pe[r] : pe[r] + mu_ * eqv[r]);
        for (int o = 0; o < NX; ++o) vv = vv + fz[o][NX + i] * adj[o];
        ss = ss + vv * vv;
      }
      best = maximum(best, root(ss));
      S nxt[NX];
      for (int i = 0; i < NX; ++i) {
        S s = lz[i];
        for (int o = 0; o < NX; ++o) s = s + fz[o][i] * adj[o];
        for (int r = 0; r < E; ++r)
          s = lag ? s + eqz[r][i] * pe[r] + pex[r][i] * eqv[r]
                  : s + mu_ * eqz[r][i] * eqv[r] + eqz[r][i] * pe[r] + pex[r][i] * eqv[r];
        nxt[i] = s;
      }
      for (int i = 0; i < NX; ++i) adj[i] = nxt[i];
    }
    return best;
  };

  // p(x) ce + (mu/2)|ce|^2 at the active step for the state and control
  // (x, u) reached there
  auto al_penalty = [&](const S* x, const S* u, S mu_) -> S {
    S total = S(0);
    if constexpr (E > 0) {
      if (ta < 0) return total;
      S ce[E];
      prob.eq(ta, x, u, ce);
      for (int r = 0; r < E; ++r) {
        const S cea = ce[r] * mrow[r];
        S p = MV(ta, r);
        for (int i = 0; i < NX; ++i) p = p + MJ(ta, r, i) * (x[i] - MO(ta, i));
        total = total + p * cea + S(0.5) * mu_ * cea * cea;
      }
    }
    return total;
  };

  auto incumbent_cost = [&](S mu_) -> S {
    S c = S(0), xa[NX], ua[M];
    for (int i = 0; i < NX; ++i) xa[i] = S(0);
    for (int j = 0; j < M; ++j) ua[j] = S(0);
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S x[NX], u[M];
      load_xu(t, x, u);
      c = c + prob.stage(x, u);
      if (t == ta) {
        for (int i = 0; i < NX; ++i) xa[i] = x[i];
        for (int j = 0; j < M; ++j) ua[j] = u[j];
      }
    }
    S xT[NX];
    for (int i = 0; i < NX; ++i) xT[i] = X(T, i);
    return c + prob.terminal(xT) + al_penalty(xa, ua, mu_);
  };

  // candidate c: the closed-loop rollout at step 2^-c about (xs, us) with
  // (k, K), kept in (xc[c], uc[c]); returns its AL cost
  auto candidate = [&](int c, S mu_) -> S {
    const S step = S(1) / S(1u << c);
    S x[NX], xa[NX], ua[M], acc = S(0);
    for (int i = 0; i < NX; ++i) {
      x[i] = X(0, i);
      xa[i] = S(0);
      XC(c, 0, i) = x[i];
    }
    for (int j = 0; j < M; ++j) ua[j] = S(0);
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S dx[NX], u[M], xn[NX];
      for (int i = 0; i < NX; ++i) dx[i] = x[i] - X(t, i);
      for (int j = 0; j < M; ++j) {
        S s = U(t, j) + step * Kf(t, j);
        for (int i = 0; i < NX; ++i) s = s + KK(t, j, i) * dx[i];
        u[j] = s;
        UC(c, t, j) = s;
      }
      if (t == ta) {
        for (int i = 0; i < NX; ++i) xa[i] = x[i];
        for (int j = 0; j < M; ++j) ua[j] = u[j];
      }
      prob.dynamics(x, u, xn);
      acc = acc + prob.stage(x, u);
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        XC(c, t + 1, i) = xn[i];
      }
    }
    return acc + prob.terminal(x) + al_penalty(xa, ua, mu_);
  };

  // ---------------- the budget: pass 0 is the pre-loop backward/forward -----
#pragma unroll 1
  for (int it = 0;; ++it) {
    const bool last = it == a.n_iters + 1;
    hoist_eq();
    // re-anchor the multipliers (and, unless this is the final pass, the
    // gains) at the trajectory (the streamed program did so at the last
    // commit), and store the derivatives along it: step t on role t mod G
#pragma unroll 1
    for (int t = role; t < T; t += G) {
      S x[NX], u[M];
      load_xu(t, x, u);
      if (!STREAM && it > 0) {
        S d[NX], df[NX];
        for (int i = 0; i < NX; ++i) {
          d[i] = x[i] - MO(t, i);
          MO(t, i) = x[i];
          if (!last) {
            df[i] = x[i] - FO(t, i);
            FO(t, i) = x[i];
          }
        }
        for (int r = 0; r < E; ++r) {
          S s = MV(t, r);
          for (int i = 0; i < NX; ++i) s = s + MJ(t, r, i) * d[i];
          MV(t, r) = s;
        }
        if (!last) {
          for (int j = 0; j < M; ++j) {
            S s = FBk(t, j);
            for (int i = 0; i < NX; ++i) s = s + FBK(t, j, i) * df[i];
            FBk(t, j) = s;
          }
        }
      }
      S lz[NZ], fz[NX][NZ];
      first_derivs<S, P>(prob, x, u, lz, fz);
      store_first(t, lz, fz);
      if (!last) {
        S lzz[NZ][NZ];
        cost_hessian<S, P>(prob, x, u, lzz);
        store_hessian(t, lzz);
      }
    }
    if (role == G - 1) {
      S xT[NX], lfx[NX], lfxx[NX][NX];
      for (int i = 0; i < NX; ++i) xT[i] = X(T, i);
      terminal_derivs<S, P>(prob, xT, lfx, lfxx);
      for (int i = 0; i < NX; ++i) {
        at(lay.lfx + i) = lfx[i];
        for (int j = 0; j < NX; ++j) at(lay.lfxx + i * NX + j) = lfxx[i][j];
      }
    }
    __syncthreads();

    // optimality measures, the two adjoints side by side
    S oo = S(0), oc = S(0), olag = S(0);
    if (it > 0) {
      if (constrained) {
        S s = S(0);
        for (int r = 0; r < E; ++r) s = s + eqr_v[r] * eqr_v[r];
        oc = root(s);
      }
      if (role == 0) flag(LANE_OO) = adjoint(0, false, mu);
      if (role == 1) flag(LANE_OLAG) = adjoint(1, true, mu);
      __syncthreads();
      oo = flag(LANE_OO);
      olag = flag(LANE_OLAG);
    }
    if (last) {
      if (live) {
        if (role == 0) {
          a.stats[b] = oc;
          a.stats[Bs + b] = olag;
          a.stats[2 * Bs + b] = mu;
          a.stats[3 * Bs + b] = reg;
          a.stats[4 * Bs + b] = w;
          a.stats[5 * Bs + b] = n_tol;
          for (int i = 0; i < NX; ++i) a.xs[ix(T, NX, i)] = X(T, i);
        }
#pragma unroll 1
        for (int t = role; t < T; t += G) {
          for (int i = 0; i < NX; ++i) a.xs[ix(t, NX, i)] = X(t, i);
          for (int j = 0; j < M; ++j) {
            a.us[ix(t, M, j)] = U(t, j);
            a.fbk[ix(t, M, j)] = FBk(t, j);
            for (int i = 0; i < NX; ++i) a.fbK[ix(t, M * NX, j * NX + i)] = FBK(t, j, i);
          }
          for (int r = 0; r < E; ++r) {
            a.mval[ix(t, E, r)] = MV(t, r);
            for (int i = 0; i < NX; ++i) a.mjac[ix(t, E * NX, r * NX + i)] = MJ(t, r, i);
          }
        }
      }
      break;
    }

    S mu_new = mu;
    bool upd_s = false, upd_f = false;
    if (it > 0) {
      // the schedule, in every role: multipliers on success, mu on failure,
      // w and n
      const bool done = olag < a.threshold && oc < a.threshold;
      const bool plateau = oo >= S(0.1) * oo_prev && !just_changed;
      bool gate = oo < fmax(w, a.w_min) || plateau;
      if (a.inner_max >= 0) gate = gate || inner >= a.inner_max;
      upd_s = !done && gate && oc < n_tol;
      upd_f = !done && gate && oc >= n_tol;
      if constexpr (E > 0) {
        if (constrained && role == 0) {
          for (int r = 0; r < E; ++r) {
            S fb_term = S(0);
            if (!a.primal)
              for (int j = 0; j < M; ++j) fb_term = fb_term + eqr_z[r][NX + j] * FBk(ta, j);
            S v_new = MV(ta, r) + mu * (eqr_v[r] + fb_term);
            if (a.has_mult_max) v_new = clip(v_new, -a.mult_max, a.mult_max);
            if (a.affine) {
              for (int i = 0; i < NX; ++i) {
                S fbj = S(0);
                if (!a.primal)
                  for (int j = 0; j < M; ++j) fbj = fbj + eqr_z[r][NX + j] * FBK(ta, j, i);
                S j_new = MJ(ta, r, i) + mu * (eqr_z[r][i] + fbj);
                if (a.has_mult_max) j_new = clip(j_new, -a.mult_max, a.mult_max);
                if (upd_s) MJ(ta, r, i) = j_new;
              }
            }
            if (upd_s) MV(ta, r) = v_new;
          }
        }
      }
      if (upd_f) mu_new = mu * a.mu_factor;
      if (a.has_mu_max && mu_new > a.mu_max) mu_new = a.mu_max;  // NaN stays NaN
      if (upd_s)
        n_tol = fmax(n_tol * power(mu, S(-0.9)), a.threshold);
      else if (upd_f)
        n_tol = power(mu_new, S(-0.1));
      if (upd_s) w = w / mu;
      __syncthreads();
    }

    // the backward sweep beside the incumbent's cost, then the candidates
    if (role == 0) flag(LANE_OK) = backward(mu_new, reg) ? S(1) : S(0);
    if (role == 1) flag(LANE_COST_OLD) = incumbent_cost(mu_new);
    __syncthreads();
    if (role < n_ls)
      flag(LANE_ACC + role) = candidate(role, mu_new) - flag(LANE_COST_OLD) <= S(0) ? S(1) : S(0);
    __syncthreads();

    // the largest accepted step of the ladder
    const bool ok = flag(LANE_OK) != S(0);
    int chosen = 0;
    bool taken = false;
    for (int c = 0; c < n_ls; ++c) {
      const bool acc = flag(LANE_ACC + c) != S(0);
      if (acc && !taken) chosen = c;
      taken = taken || acc;
    }
    const bool keep = ok && taken;  // only ok lanes that accepted a step move
    const S step_taken = taken ? S(1) / S(1u << chosen) : S(0);
    if (it == 0) {
      if (!ok) reg = fmax(reg, mu) * S(2);
    } else if (ok) {
      if (step_taken >= S(0.5)) reg = (reg / S(2) < S(1e-5)) ? S(0) : reg / S(2);
    } else {
      reg = fmax(reg, mu_new) * S(2);
    }

    // commit the gains (anchored at the trajectory they were computed about;
    // before the iterations at the one the line search moved to) and the
    // trajectory, step t on role t mod G
    if constexpr (!STREAM) {
#pragma unroll 1
      for (int t = role; t < T; t += G) {
        if (keep)
          for (int j = 0; j < M; ++j) U(t, j) = UC(chosen, t, j);
        if (ok) {
          for (int j = 0; j < M; ++j) {
            FBk(t, j) = Kf(t, j);
            for (int i = 0; i < NX; ++i) FBK(t, j, i) = KK(t, j, i);
          }
        }
        for (int i = 0; i < NX; ++i) {
          // xs[t]: t = 0 never moves, t >= 1 moves with keep
          const S x_old = X(t, i);
          const S x_new = (keep && t > 0) ? XC(chosen, t, i) : x_old;
          if (ok) FO(t, i) = (it == 0) ? x_new : x_old;
          if (keep && t > 0) X(t, i) = x_new;
        }
      }
    } else {
      // streamed: the same commit and, from the same loads, the next pass's
      // re-anchoring of the multipliers and (unless that pass is the final
      // one) of the gains, as that pass would compute it; two steps at a
      // time, every load from the scratch before any store to it
      const bool next_last = it == a.n_iters;
      struct Cold {
        S uc[M], xc[NX], mo[NX], mv[EK], mj[EK][NX], fo[NX], fbk[M], fbK[M][NX];
      };
      auto fetch = [&](int t, Cold& c) {
        if (keep) {
          for (int j = 0; j < M; ++j) c.uc[j] = UC(chosen, t, j);
          if (t > 0)
            for (int i = 0; i < NX; ++i) c.xc[i] = XC(chosen, t, i);
        }
        for (int i = 0; i < NX; ++i) c.mo[i] = MO(t, i);
        for (int r = 0; r < E; ++r) {
          c.mv[r] = MV(t, r);
          for (int i = 0; i < NX; ++i) c.mj[r][i] = MJ(t, r, i);
        }
        if (!ok && !next_last) {
          for (int i = 0; i < NX; ++i) c.fo[i] = FO(t, i);
          for (int j = 0; j < M; ++j) {
            c.fbk[j] = FBk(t, j);
            for (int i = 0; i < NX; ++i) c.fbK[j][i] = FBK(t, j, i);
          }
        }
      };
      auto settle = [&](int t, Cold& c) {
        if (keep)
          for (int j = 0; j < M; ++j) U(t, j) = c.uc[j];
        if (ok) {
          for (int j = 0; j < M; ++j) {
            c.fbk[j] = Kf(t, j);
            for (int i = 0; i < NX; ++i) c.fbK[j][i] = KK(t, j, i);
          }
        }
        S x[NX], d[NX];
        for (int i = 0; i < NX; ++i) {
          const S x_old = X(t, i);
          const S x_new = (keep && t > 0) ? c.xc[i] : x_old;
          if (ok) c.fo[i] = (it == 0) ? x_new : x_old;
          if (keep && t > 0) X(t, i) = x_new;
          x[i] = (keep && t > 0) ? x_new : x_old;
          d[i] = x[i] - c.mo[i];
          MO(t, i) = x[i];
        }
        for (int r = 0; r < E; ++r) {
          S s = c.mv[r];
          for (int i = 0; i < NX; ++i) s = s + c.mj[r][i] * d[i];
          MV(t, r) = s;
        }
        if (!next_last) {
          S df[NX];
          for (int i = 0; i < NX; ++i) {
            df[i] = x[i] - c.fo[i];
            FO(t, i) = x[i];
          }
          for (int j = 0; j < M; ++j) {
            S s = c.fbk[j];
            for (int i = 0; i < NX; ++i) s = s + c.fbK[j][i] * df[i];
            FBk(t, j) = s;
            if (ok)
              for (int i = 0; i < NX; ++i) FBK(t, j, i) = c.fbK[j][i];
          }
        } else if (ok) {
          for (int i = 0; i < NX; ++i) FO(t, i) = c.fo[i];
          for (int j = 0; j < M; ++j) {
            FBk(t, j) = c.fbk[j];
            for (int i = 0; i < NX; ++i) FBK(t, j, i) = c.fbK[j][i];
          }
        }
      };
#pragma unroll 1
      for (int t = role; t < T; t += 2 * G) {
        Cold c0, c1;
        const bool two = t + G < T;
        fetch(t, c0);
        if (two) fetch(t + G, c1);
        settle(t, c0);
        if (two) settle(t + G, c1);
      }
    }
    if (keep && role == 0)
      for (int i = 0; i < NX; ++i) X(T, i) = XC(chosen, T, i);
    __syncthreads();

    mu = mu_new;
    oo_prev = oo;
    just_changed = upd_s || upd_f;
    inner = just_changed ? 1 : inner + 1;
  }
}

// ------------------------------------------------------------ launch

#if !defined(DDP_DYN) || !defined(DDP_COST) || !defined(DDP_E)
#error "build with -DDDP_DYN=, -DDDP_COST= and -DDDP_E= (kernels/_build.py::load)"
#endif

// The launch plan of this build's class over (T, B, n_ls) in S on the
// current device (`program` -1: the plan's choice, 0 resident, 1 streamed):
// out[] = G, LPB, shared-memory bytes a block, the program, blocks an SM
// holds, blocks, waves, and the streamed program's scratch rows and row
// stride (0 and 0 for the resident program).  Returns 0, -1 for counts this
// build does not take or a lane that does not fit, or a CUDA error.
template <typename S>
int plan_launch(int T, int B, int n_ls, int program, int* out) {
  using P = PendulumClass<S, DDP_DYN, DDP_COST, DDP_E>;
  if (n_ls < 1 || n_ls > 31 || T < 1 || program < -1 || program > 1) return -1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks an SM holds of a program's instantiation (shared memory, threads
  // and registers); 0, with the error cleared, where it cannot run
  auto occupancy = [](int stream, int threads, long smem) {
    auto kernel = stream ? flat_solve_kernel<S, P, true> : flat_solve_kernel<S, P, false>;
    int blocks = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      static_cast<size_t>(smem)) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return blocks;
  };
  FlatSolvePlan fp;
  if (!flat_solve_plan(T, P::NX, P::M, P::NE, n_ls, sizeof(S), B, sms, program, occupancy, &fp))
    return -1;
  const int rows = fp.stream ? ScratchLayout(T, P::NX, P::M, P::NE, n_ls).total : 0;
  const int stride = fp.stream ? fp.blocks * fp.LPB : 0;
  const int plan[] = {fp.G, fp.LPB, static_cast<int>(fp.smem), fp.stream, fp.per_sm, fp.blocks,
                      fp.waves, rows, stride};
  for (int i = 0; i < 9; ++i) out[i] = plan[i];
  return 0;
}

template <typename S>
int launch(const void* const* p, const int* n, const double* r, const int* plan,
           cudaStream_t stream) {
  using P = PendulumClass<S, DDP_DYN, DDP_COST, DDP_E>;
  SolveArgs<S> a;
  a.x0 = static_cast<const S*>(p[0]);
  a.us0 = static_cast<const S*>(p[1]);
  a.scal = static_cast<const S*>(p[2]);
  a.consts = static_cast<const S*>(p[3]);
  a.mrow = static_cast<const S*>(p[4]);
  S** out[] = {&a.us, &a.xs, &a.fbk, &a.fbK, &a.stats, &a.mval, &a.mjac, &a.scratch};
  for (int i = 0; i < 8; ++i) *out[i] = static_cast<S*>(const_cast<void*>(p[5 + i]));
  a.T = n[0];
  a.B = n[1];
  a.n_iters = n[2];
  a.n_ls = n[3];
  a.ta = n[4];
  a.affine = n[5];
  a.primal = n[6];
  a.has_mu_max = n[7];
  a.has_mult_max = n[8];
  a.inner_max = n[9];
  a.threshold = static_cast<S>(r[0]);
  a.w_min = static_cast<S>(r[1]);
  a.mu_factor = static_cast<S>(r[2]);
  a.mu_max = static_cast<S>(r[3]);
  a.mult_max = static_cast<S>(r[4]);
  if (a.B <= 0) return 0;  // an empty grid is not a valid launch
  if (a.n_ls < 1 || a.n_ls > 31 || a.T < 1 || a.ta >= a.T) return -1;
  a.G = plan[0];
  a.LPB = plan[1];
  a.stride = static_cast<size_t>(plan[8]);
  const int smem = plan[2], blocks = plan[5];
  auto kernel = plan[3] ? flat_solve_kernel<S, P, true> : flat_solve_kernel<S, P, false>;
  // another plan of this instantiation may have set a smaller maximum
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, a.G * a.LPB, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded through ctypes.  ``dyn``, ``cost`` and ``e``
// name the problem class (kernels/flat_problem.py); each returns -2 for a
// class this library was not built for.
//
// ddp_flat_solve_plan: the launch plan on the current device.  ``ints``
// (host): T, B, n_ls, the program (-1: the plan's choice, 0 resident, 1
// streamed).  ``plan`` (host) receives 9 ints: G threads a lane, LPB lanes a
// block, shared-memory bytes a block, the program, blocks an SM holds,
// blocks, waves, and the streamed program's scratch rows and row stride (the
// scratch is [rows, stride], a column a lane of every block; 0 and 0 for the
// resident program).  Returns 0, -1 for counts this build does not take or a
// lane too large for the shared memory, or a CUDA error.
//
// ddp_flat_solve: one launch on that plan.  ``ptrs``: 13 device pointers in
// the order x0, us0, scal, consts, mrow, then the outputs us, xs, fbk, fbK,
// stats, mval, mjac, then the scratch.  ``ints`` (host): T, B, n_iters, n_ls,
// ta (-1: unconstrained), affine, primal, has_mu_max, has_mult_max,
// inner_max (-1: none).  ``reals`` (host): threshold, w_min, mu_factor,
// mu_max, mult_max.  ``plan`` (host): ddp_flat_solve_plan's 9 ints for the
// same class, T, B, n_ls and type.  Returns cudaGetLastError() after the
// launch, or -1 for counts this build does not take.
extern "C" int ddp_flat_solve_plan(int is_double, int dyn, int cost, int e, const int* ints,
                                   int* plan) {
  if (dyn != DDP_DYN || cost != DDP_COST || e != DDP_E) return -2;
  return is_double ? plan_launch<double>(ints[0], ints[1], ints[2], ints[3], plan)
                   : plan_launch<float>(ints[0], ints[1], ints[2], ints[3], plan);
}

extern "C" int ddp_flat_solve(int is_double, int dyn, int cost, int e, const void* const* ptrs,
                              const int* ints, const double* reals, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dyn != DDP_DYN || cost != DDP_COST || e != DDP_E) return -2;
  return is_double ? launch<double>(ptrs, ints, reals, plan, s)
                   : launch<float>(ptrs, ints, reals, plan, s);
}
