// The whole fixed-budget batched AL-DDP solve of a flat-lane problem in one
// launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/flat_solve.py (_solve_kernel,
// launched by solve_flat_pallas's pl.pallas_call); wrapper and plain version:
// ddp_tpu_torch/kernels/flat_solve.py.
//
// Program of one lane: the initial rollout; then, before the iterations and
// in each of them, the fused derivative + Riccati reverse sweep (Gauss-Newton,
// AL multiplier terms, one regularization level), the line search (incumbent
// cost, n_ls closed-loop rollouts at the steps 2^-c, the largest step whose
// AL cost did not rise, one more rollout at that step), the commit of the
// trajectory (only if every pivot was positive and a step was accepted) and
// of the gains; in each iteration before that the re-anchoring of multipliers
// and gains at the trajectory, both optimality adjoints, and the schedule of
// multipliers, mu, w, n and reg; at the end the final measures.  The
// constraint is active at one step `ta`: its value and Jacobian are evaluated
// there once per iteration and enter the sweeps behind t == ta.
//
// Derivatives come from the problem class's device functions
// (flat_problem.cuh) evaluated in Dual numbers (cost gradient, dynamics and
// constraint Jacobians) and HyperDual numbers (cost Hessian), which is what
// forward-mode differentiation does in the TPU kernel.
//
// Threads and memory: one thread runs one lane's whole solve, 128 threads a
// block.  The lane's working arrays (trajectory, controls, gains, candidate
// rollout, multipliers, anchors: about 680 scalars with the outputs) are the
// wrapper's [T, rows, B] tensors, the batch last, so neighbouring threads
// touch neighbouring addresses and every access is coalesced; at B = 4096 in
// float they are about 11 MB and stay in the 50 MB L2.  Vx, Vxx, the
// constraint rows and the schedule state live in registers.  The outputs
// double as working storage.  The time loops and the loops over iterations
// and candidates stay loops (#pragma unroll 1): T, the iteration budget, the
// candidate count, ta, the method and every threshold are run-time arguments;
// only (NX, M, E), the scalar type and the problem class are compiled in.
//
// Bound: not bytes (inputs and outputs are 1.6 MB at the headline) and not
// the card's arithmetic rate, but the length of a lane's dependent chain:
// (iterations + 1) x (n_ls + 4) x T step evaluations one after the other in
// one thread, and at B = 4096 only 32 blocks for 132 SMs.  A simple kernel
// that is right; splitting a lane's candidates over threads is later work.
//
// A failed factorization gives NaN gains through sqrt of a negative pivot and
// ok = false for the lane, which then keeps its trajectory and escalates its
// reg: build without --use_fast_math and without -ftz.

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

template <typename S>
struct SolveArgs {
  // inputs
  const S* x0;      // [NX, B]
  const S* us0;     // [T, M, B]
  const S* scal;    // [4, B]: mu, reg, w, n
  const S* consts;  // the problem class's constants
  const S* mrow;    // [E] 0/1 mask of the constraint rows at ta
  // outputs, also working storage
  S* us;     // [T, M, B]
  S* xs;     // [T+1, NX, B]
  S* fbk;    // [T, M, B]
  S* fbK;    // [T, M*NX, B]
  S* stats;  // [6, B]: opt_constr, opt_lag, mu, reg, w, n
  S* mval;   // [T, E, B]
  S* mjac;   // [T, E*NX, B]
  // scratch
  S* k;       // [T, M, B]
  S* K;       // [T, M*NX, B]
  S* xc;      // [T+1, NX, B] candidate rollout
  S* uc;      // [T, M, B]
  S* morig;   // [T, NX, B] anchor of the multipliers
  S* fborig;  // [T, NX, B] anchor of the gains
  int T, B, n_iters, n_ls, ta, advance, affine, primal, has_mu_max, has_mult_max;
  int inner_max;  // -1: none
  S threshold, w_min, mu_factor, mu_max, mult_max;
};

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

template <typename S, typename P, int E>
__global__ void __launch_bounds__(128) flat_solve_kernel(SolveArgs<S> a) {
  static_assert(E == 0 || E == P::NE, "constraint rows of the problem class");
  constexpr int NX = P::NX, M = P::M, NZ = NX + M;
  constexpr int EK = E > 0 ? E : 1;  // array extents; loops run to E
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const size_t Bs = static_cast<size_t>(a.B);
  const int T = a.T, ta = a.ta;
  const P prob(a.consts, a.advance);
  // element (t, r) of a [T, rows, B] array, this thread's lane
  auto ix = [&](int t, int rows, int r) -> size_t {
    return (static_cast<size_t>(t) * rows + r) * Bs + b;
  };
  const bool constrained = E > 0 && ta >= 0;
  S mrow[EK];
  for (int r = 0; r < E; ++r) mrow[r] = a.mrow[r];
  // the constraint's masked value and Jacobian at the active step
  S eqr_v[EK], eqr_z[EK][NZ];
  for (int r = 0; r < EK; ++r) {
    eqr_v[r] = S(0);
    for (int j = 0; j < NZ; ++j) eqr_z[r][j] = S(0);
  }

  // ---------------- initial rollout, zero multipliers and gains -------------
  {
    S x[NX];
    for (int i = 0; i < NX; ++i) {
      x[i] = a.x0[i * Bs + b];
      a.xs[ix(0, NX, i)] = x[i];
    }
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S u[M], xn[NX];
      for (int j = 0; j < M; ++j) {
        u[j] = a.us0[ix(t, M, j)];
        a.us[ix(t, M, j)] = u[j];
        a.fbk[ix(t, M, j)] = S(0);
        for (int i = 0; i < NX; ++i) a.fbK[ix(t, M * NX, j * NX + i)] = S(0);
      }
      for (int r = 0; r < E; ++r) {
        a.mval[ix(t, E, r)] = S(0);
        for (int i = 0; i < NX; ++i) a.mjac[ix(t, E * NX, r * NX + i)] = S(0);
      }
      for (int i = 0; i < NX; ++i) {
        a.morig[ix(t, NX, i)] = x[i];
        a.fborig[ix(t, NX, i)] = x[i];
      }
      prob.dynamics(x, u, xn);
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        a.xs[ix(t + 1, NX, i)] = xn[i];
      }
    }
  }

  S mu = a.scal[b], reg = a.scal[Bs + b], w = a.scal[2 * Bs + b], n_tol = a.scal[3 * Bs + b];
  S oo_prev = S(INFINITY);
  bool just_changed = true;
  int inner = 1;  // the pre-loop backward/forward already ran

  // ---------------- stages ---------------------------------------------------
  auto load_xu = [&](const S* X, const S* U, int t, S* x, S* u) {
    for (int i = 0; i < NX; ++i) x[i] = X[ix(t, NX, i)];
    for (int j = 0; j < M; ++j) u[j] = U[ix(t, M, j)];
  };

  // constraint value and Jacobian at the active step on the current (xs, us)
  auto hoist_eq = [&]() {
    if constexpr (E > 0) {
      if (ta < 0) return;
      S x[NX], u[M], ev[E];
      load_xu(a.xs, a.us, ta, x, u);
      prob.eq(x, u, ev);
      for (int r = 0; r < E; ++r) eqr_v[r] = ev[r] * mrow[r];
      for (int j = 0; j < NZ; ++j) {
        Dual<S> xd[NX], ud[M], ed[E];
        for (int i = 0; i < NX; ++i) xd[i] = Dual<S>(x[i], i == j ? S(1) : S(0));
        for (int i = 0; i < M; ++i) ud[i] = Dual<S>(u[i], NX + i == j ? S(1) : S(0));
        prob.eq(xd, ud, ed);
        for (int r = 0; r < E; ++r) eqr_z[r][j] = ed[r].t * mrow[r];
      }
    }
  };

  // the hoisted rows behind t == ta, and the multipliers of step t
  auto eq_rows = [&](int t, S* eqv, S (*eqz)[NZ], S* pe, S (*pex)[NX]) {
    const S sel = (constrained && t == ta) ? S(1) : S(0);
    for (int r = 0; r < E; ++r) {
      eqv[r] = eqr_v[r] * sel;
      for (int j = 0; j < NZ; ++j) eqz[r][j] = eqr_z[r][j] * sel;
      pe[r] = a.mval[ix(t, E, r)];
      for (int i = 0; i < NX; ++i) pex[r][i] = a.mjac[ix(t, E * NX, r * NX + i)];
    }
  };

  // fused derivative + Riccati reverse sweep: writes k, K; true iff every
  // pivot of every step was positive and finite
  auto backward = [&](S mu_, S reg_) -> bool {
    S Vx[NX], Vxx[NX][NX];
    {
      S xT[NX];
      for (int i = 0; i < NX; ++i) xT[i] = a.xs[ix(T, NX, i)];
      terminal_derivs<S, P>(prob, xT, Vx, Vxx);
    }
    bool ok = true;
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      S x[NX], u[M], lz[NZ], lzz[NZ][NZ], fz[NX][NZ];
      load_xu(a.xs, a.us, t, x, u);
      first_derivs<S, P>(prob, x, u, lz, fz);
      cost_hessian<S, P>(prob, x, u, lzz);
      S eqv[EK], eqz[EK][NZ], pe[EK], pex[EK][NX], tmp[EK], tmp2[EK][NX];
      eq_rows(t, eqv, eqz, pe, pex);
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
      S X[1 + NX][M];  // X[0] = Quu^-1 Qu, X[1 + j] = Quu^-1 Qux[:, j]
      for (int c = 0; c <= NX; ++c) {
        for (int i = 0; i < M; ++i) X[c][i] = (c == 0) ? Qz[NX + i] : Qzz[NX + i][c - 1];
        chol_apply<S, M>(L, X[c]);
      }
      for (int i = 0; i < M; ++i) {
        a.k[ix(t, M, i)] = -X[0][i];
        for (int j = 0; j < NX; ++j) a.K[ix(t, M * NX, i * NX + j)] = -X[1 + j][i];
      }
      for (int i = 0; i < NX; ++i) {
        S s = Qz[i];
        for (int o = 0; o < M; ++o) s = s - Qzz[NX + o][i] * X[0][o];
        Vx[i] = s;
      }
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
          S s = Qzz[i][j];
          for (int o = 0; o < M; ++o) s = s - Qzz[NX + o][i] * X[1 + j][o];
          Vxx[i][j] = s;
        }
      }
    }
    return ok;
  };

  // p(x) ce + (mu/2)|ce|^2 at the active step for the state and control
  // (x, u) reached there
  auto al_penalty = [&](const S* x, const S* u, S mu_) -> S {
    S total = S(0);
    if constexpr (E > 0) {
      if (ta < 0) return total;
      S ce[E];
      prob.eq(x, u, ce);
      for (int r = 0; r < E; ++r) {
        const S cea = ce[r] * mrow[r];
        S p = a.mval[ix(ta, E, r)];
        for (int i = 0; i < NX; ++i)
          p = p + a.mjac[ix(ta, E * NX, r * NX + i)] * (x[i] - a.morig[ix(ta, NX, i)]);
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
      load_xu(a.xs, a.us, t, x, u);
      c = c + prob.stage(x, u);
      if (t == ta) {
        for (int i = 0; i < NX; ++i) xa[i] = x[i];
        for (int j = 0; j < M; ++j) ua[j] = u[j];
      }
    }
    S xT[NX];
    for (int i = 0; i < NX; ++i) xT[i] = a.xs[ix(T, NX, i)];
    return c + prob.terminal(xT) + al_penalty(xa, ua, mu_);
  };

  // closed-loop rollout at `step` about (xs, us) with (k, K); returns its AL
  // cost; with `store` the trajectory goes to (xc, uc)
  auto rollout_cost = [&](S step, S mu_, bool store) -> S {
    S x[NX], xa[NX], ua[M], acc = S(0);
    for (int i = 0; i < NX; ++i) {
      x[i] = a.xs[ix(0, NX, i)];
      xa[i] = S(0);
      if (store) a.xc[ix(0, NX, i)] = x[i];
    }
    for (int j = 0; j < M; ++j) ua[j] = S(0);
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S dx[NX], u[M], xn[NX];
      for (int i = 0; i < NX; ++i) dx[i] = x[i] - a.xs[ix(t, NX, i)];
      for (int j = 0; j < M; ++j) {
        S s = a.us[ix(t, M, j)] + step * a.k[ix(t, M, j)];
        for (int i = 0; i < NX; ++i) s = s + a.K[ix(t, M * NX, j * NX + i)] * dx[i];
        u[j] = s;
        if (store) a.uc[ix(t, M, j)] = s;
      }
      if (t == ta) {
        for (int i = 0; i < NX; ++i) xa[i] = x[i];
        for (int j = 0; j < M; ++j) ua[j] = u[j];
      }
      prob.dynamics(x, u, xn);
      acc = acc + prob.stage(x, u);
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        if (store) a.xc[ix(t + 1, NX, i)] = xn[i];
      }
    }
    return acc + prob.terminal(x) + al_penalty(xa, ua, mu_);
  };

  // ---------------- the budget: pass 0 is the pre-loop backward/forward -----
#pragma unroll 1
  for (int it = 0;; ++it) {
    const bool last = it == a.n_iters + 1;
    hoist_eq();
    S oo = S(0), oc = S(0), olag = S(0);
    if (it > 0) {
      // re-anchor the multipliers (and, unless this is the final pass, the
      // gains) at the trajectory
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        S d[NX], df[NX];
        for (int i = 0; i < NX; ++i) {
          const S x = a.xs[ix(t, NX, i)];
          d[i] = x - a.morig[ix(t, NX, i)];
          a.morig[ix(t, NX, i)] = x;
          if (!last) {
            df[i] = x - a.fborig[ix(t, NX, i)];
            a.fborig[ix(t, NX, i)] = x;
          }
        }
        for (int r = 0; r < E; ++r) {
          S s = a.mval[ix(t, E, r)];
          for (int i = 0; i < NX; ++i) s = s + a.mjac[ix(t, E * NX, r * NX + i)] * d[i];
          a.mval[ix(t, E, r)] = s;
        }
        if (!last) {
          for (int j = 0; j < M; ++j) {
            S s = a.fbk[ix(t, M, j)];
            for (int i = 0; i < NX; ++i) s = s + a.fbK[ix(t, M * NX, j * NX + i)] * df[i];
            a.fbk[ix(t, M, j)] = s;
          }
        }
      }

      // optimality measures by the reverse adjoint recursion
      if (constrained) {
        S s = S(0);
        for (int r = 0; r < E; ++r) s = s + eqr_v[r] * eqr_v[r];
        oc = root(s);
      }
      S a_o[NX], a_l[NX];
      {
        S xT[NX], lfxx[NX][NX];
        for (int i = 0; i < NX; ++i) xT[i] = a.xs[ix(T, NX, i)];
        terminal_derivs<S, P>(prob, xT, a_o, lfxx);
        for (int i = 0; i < NX; ++i) a_l[i] = a_o[i];
      }
#pragma unroll 1
      for (int t = T - 1; t >= 0; --t) {
        S x[NX], u[M], lz[NZ], fz[NX][NZ];
        load_xu(a.xs, a.us, t, x, u);
        first_derivs<S, P>(prob, x, u, lz, fz);
        S eqv[EK], eqz[EK][NZ], pe[EK], pex[EK][NX];
        eq_rows(t, eqv, eqz, pe, pex);
        S so = S(0), sl = S(0);
        for (int i = 0; i < M; ++i) {
          S vo = lz[NX + i], vel = lz[NX + i];
          for (int r = 0; r < E; ++r) {
            vo = vo + eqz[r][NX + i] * (pe[r] + mu * eqv[r]);
            vel = vel + eqz[r][NX + i] * pe[r];
          }
          for (int o = 0; o < NX; ++o) {
            vo = vo + fz[o][NX + i] * a_o[o];
            vel = vel + fz[o][NX + i] * a_l[o];
          }
          so = so + vo * vo;
          sl = sl + vel * vel;
        }
        oo = fmax(oo, root(so));
        olag = fmax(olag, root(sl));
        S n_o[NX], n_l[NX];
        for (int i = 0; i < NX; ++i) {
          S ao = lz[i], al = lz[i];
          for (int o = 0; o < NX; ++o) {
            ao = ao + fz[o][i] * a_o[o];
            al = al + fz[o][i] * a_l[o];
          }
          for (int r = 0; r < E; ++r) {
            ao = ao + mu * eqz[r][i] * eqv[r] + eqz[r][i] * pe[r] + pex[r][i] * eqv[r];
            al = al + eqz[r][i] * pe[r] + pex[r][i] * eqv[r];
          }
          n_o[i] = ao;
          n_l[i] = al;
        }
        for (int i = 0; i < NX; ++i) {
          a_o[i] = n_o[i];
          a_l[i] = n_l[i];
        }
      }
    }
    if (last) {
      a.stats[b] = oc;
      a.stats[Bs + b] = olag;
      a.stats[2 * Bs + b] = mu;
      a.stats[3 * Bs + b] = reg;
      a.stats[4 * Bs + b] = w;
      a.stats[5 * Bs + b] = n_tol;
      break;
    }

    S mu_new = mu;
    bool upd_s = false, upd_f = false;
    if (it > 0) {
      // the schedule: multipliers on success, mu on failure, w and n
      const bool done = olag < a.threshold && oc < a.threshold;
      const bool plateau = oo >= S(0.1) * oo_prev && !just_changed;
      bool gate = oo < fmax(w, a.w_min) || plateau;
      if (a.inner_max >= 0) gate = gate || inner >= a.inner_max;
      upd_s = !done && gate && oc < n_tol;
      upd_f = !done && gate && oc >= n_tol;
      if constexpr (E > 0) {
        if (constrained) {
          for (int r = 0; r < E; ++r) {
            S fb_term = S(0);
            if (!a.primal)
              for (int j = 0; j < M; ++j) fb_term = fb_term + eqr_z[r][NX + j] * a.fbk[ix(ta, M, j)];
            S v_new = a.mval[ix(ta, E, r)] + mu * (eqr_v[r] + fb_term);
            if (a.has_mult_max) v_new = fmin(fmax(v_new, -a.mult_max), a.mult_max);
            if (upd_s) a.mval[ix(ta, E, r)] = v_new;
            if (a.affine) {
              for (int i = 0; i < NX; ++i) {
                S fbj = S(0);
                if (!a.primal)
                  for (int j = 0; j < M; ++j)
                    fbj = fbj + eqr_z[r][NX + j] * a.fbK[ix(ta, M * NX, j * NX + i)];
                S j_new = a.mjac[ix(ta, E * NX, r * NX + i)] + mu * (eqr_z[r][i] + fbj);
                if (a.has_mult_max) j_new = fmin(fmax(j_new, -a.mult_max), a.mult_max);
                if (upd_s) a.mjac[ix(ta, E * NX, r * NX + i)] = j_new;
              }
            }
          }
        }
      }
      if (upd_f) mu_new = mu * a.mu_factor;
      if (a.has_mu_max) mu_new = fmin(mu_new, a.mu_max);
      if (upd_s)
        n_tol = fmax(n_tol * power(mu, S(-0.9)), a.threshold);
      else if (upd_f)
        n_tol = power(mu_new, S(-0.1));
      if (upd_s) w = w / mu;
    }

    const bool ok = backward(mu_new, reg);

    // line search: the largest step of the ladder whose AL cost did not rise
    const S cost_old = incumbent_cost(mu_new);
    S chosen = S(0);
    bool taken = false;
#pragma unroll 1
    for (int c = 0; c < a.n_ls; ++c) {
      const S step = S(1) / S(1u << c);
      const bool acc = rollout_cost(step, mu_new, false) - cost_old <= S(0);
      if (acc && !taken) chosen = step;
      taken = taken || acc;
    }
    const bool keep = ok && taken;  // only ok lanes that accepted a step move
    if (keep) rollout_cost(chosen, mu_new, true);
    const S step_taken = taken ? chosen : S(0);

    if (it == 0) {
      if (!ok) reg = fmax(reg, mu) * S(2);
    } else if (ok) {
      if (step_taken >= S(0.5)) reg = (reg / S(2) < S(1e-5)) ? S(0) : reg / S(2);
    } else {
      reg = fmax(reg, mu_new) * S(2);
    }

    // commit the gains (anchored at the trajectory they were computed about;
    // before the iterations at the one the line search moved to) and the
    // trajectory
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      if (keep) {
        for (int j = 0; j < M; ++j) a.us[ix(t, M, j)] = a.uc[ix(t, M, j)];
      }
      if (ok) {
        for (int j = 0; j < M; ++j) {
          a.fbk[ix(t, M, j)] = a.k[ix(t, M, j)];
          for (int i = 0; i < NX; ++i)
            a.fbK[ix(t, M * NX, j * NX + i)] = a.K[ix(t, M * NX, j * NX + i)];
        }
      }
      for (int i = 0; i < NX; ++i) {
        // xs[t]: t = 0 never moves, t >= 1 moves with keep
        const S x_old = a.xs[ix(t, NX, i)];
        const S x_new = (keep && t > 0) ? a.xc[ix(t, NX, i)] : x_old;
        if (ok) a.fborig[ix(t, NX, i)] = (it == 0) ? x_new : x_old;
        if (keep && t > 0) a.xs[ix(t, NX, i)] = x_new;
      }
    }
    if (keep)
      for (int i = 0; i < NX; ++i) a.xs[ix(T, NX, i)] = a.xc[ix(T, NX, i)];

    mu = mu_new;
    oo_prev = oo;
    just_changed = upd_s || upd_f;
    inner = just_changed ? 1 : inner + 1;
  }
}

template <typename S, typename P, int E>
int launch(const void* const* p, const int* n, const double* r, cudaStream_t stream) {
  SolveArgs<S> a;
  a.x0 = static_cast<const S*>(p[0]);
  a.us0 = static_cast<const S*>(p[1]);
  a.scal = static_cast<const S*>(p[2]);
  a.consts = static_cast<const S*>(p[3]);
  a.mrow = static_cast<const S*>(p[4]);
  S** out[] = {&a.us, &a.xs, &a.fbk, &a.fbK, &a.stats, &a.mval, &a.mjac,
               &a.k,  &a.K,  &a.xc,  &a.uc,  &a.morig, &a.fborig};
  for (int i = 0; i < 13; ++i) *out[i] = static_cast<S*>(const_cast<void*>(p[5 + i]));
  a.T = n[0];
  a.B = n[1];
  a.n_iters = n[2];
  a.n_ls = n[3];
  a.ta = n[4];
  a.advance = n[5];
  a.affine = n[6];
  a.primal = n[7];
  a.has_mu_max = n[8];
  a.has_mult_max = n[9];
  a.inner_max = n[10];
  a.threshold = static_cast<S>(r[0]);
  a.w_min = static_cast<S>(r[1]);
  a.mu_factor = static_cast<S>(r[2]);
  a.mu_max = static_cast<S>(r[3]);
  a.mult_max = static_cast<S>(r[4]);
  if (a.B <= 0) return 0;  // an empty grid is not a valid launch
  if (a.n_ls < 1 || a.n_ls > 31 || a.T < 1 || a.ta >= a.T) return -1;
  const int threads = 128;
  const int blocks = (a.B + threads - 1) / threads;
  flat_solve_kernel<S, P, E><<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_class(int class_id, int nx, int m, int e, const void* const* p, const int* n,
                 const double* r, cudaStream_t s) {
  if (class_id == 0 && nx == 2 && m == 1) {
    using P = PendulumEulerTarget<S>;
    if (e == 1) return launch<S, P, 1>(p, n, r, s);
    if (e == 0) return launch<S, P, 0>(p, n, r, s);
  }
  return -1;
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``ptrs``: 18 device pointers
// in the order x0, us0, scal, consts, mrow, then the outputs us, xs, fbk, fbK,
// stats, mval, mjac, then the scratch k, K, xc, uc, morig, fborig.  ``ints``
// (host): T, B, n_iters, n_ls, ta (-1: unconstrained), advance, affine,
// primal, has_mu_max, has_mult_max, inner_max (-1: none).  ``reals`` (host):
// threshold, w_min, mu_factor, mu_max, mult_max.  Returns cudaGetLastError()
// after the launch; -1 for a class, dims or counts this build does not take.
extern "C" int ddp_flat_solve(int is_double, int class_id, int nx, int m, int e,
                              const void* const* ptrs, const int* ints, const double* reals,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch_class<double>(class_id, nx, m, e, ptrs, ints, reals, s)
                   : launch_class<float>(class_id, nx, m, e, ptrs, ints, reals, s);
}
