// The problem inside the flat-lane kernels (linesearch_flat.cu,
// flat_solve.cu): one policy struct of device functions templated on the
// value type V, so the same source gives the value (V = S), a first
// derivative (V = Dual<S>) and a second derivative (V = HyperDual<S>) of the
// dynamics, the costs and the constraint.  The kernels take the policy as a
// template argument.
//
// The TPU kernels rebuild the problem's pytree per lane from a packed vector
// and trace its Python methods; here the source is fixed and the problem is
// data: the wrapper (ddp_tpu_torch/kernels/flat_problem.py) walks the
// Problem's modules and hands over a buffer of constants (its LAYOUT).
//
// The class: the closed-form pendulum  a = -(g/l) sin q + tau/m  under Euler
// or RK4; the cost  (c/2)|u|^2  (lf = 0), a quadratic tracking cost
// (1/2)(x - x_ref)' Q (x - x_ref) + (1/2) u' R u with  lf = (1/2) e' Qf e,
// or the manifold tracking cost through x ⊖ x_ref with its terminal scale;
// and a constraint of E rows stacked from leaves, each a configuration
// target (1 row: q_k - target), a state target (2 rows: x_k - target) or a
// trajectory configuration target (1 row: q_k - targets[clip(t + n, 0,
// T_pad - 1)]), where x_k is the state reached from (x, u) through the
// leaf's n advance layers, outermost first, each a step of its own pendulum
// dynamics (integrator, dt, mass, length) under the same u, and t + n the
// leaf's own time index.
//
// What is compiled in and what is data.  A template argument is what changes
// the shape of the arithmetic a step evaluates: the problem's integrator
// (DYN: 0 Euler, 1 RK4 — four accelerations or one), the cost kind (COST:
// 0 control, 1 tracking, 2 manifold tracking — which terms, which terminal
// cost) and the row count E (the kernels' array extents and their shared
// memory plan).  One library is built per (DYN, COST, E).  Everything else
// is data read from the buffer: the constants, the cost's weights and
// reference, and the constraint's structure — each leaf's kind, its advance
// layers with each layer's integrator, dt, mass and length, its target or
// target table — so a new target, weight, schedule, layer count or layer
// dynamics never rebuilds a library.  The constraint is evaluated only where
// the mask marks a row (once an iteration in the whole solve), so its
// data-driven loops are off the kernels' per-step chain; the per-step
// dynamics and cost read their constants from registers.
//
// A policy offers
//   NX, M        state and control width (vector-space state, nx == ndx)
//   NE           rows of its equality constraint (E)
//   dynamics(x, u, x_next), stage(x, u), terminal(x), eq(t, x, u, out)
// where only eq depends on the time index t (the trajectory target's row).
//
// Operation order: every function keeps the order of ddp_tpu_torch's
// modules (ocp/dynamics.py, ocp/costs.py, models/pendulum.py), whose plain
// versions the kernels are held to: g/l is (1/l) * 9.81 as torch's
// reverse division computes it, RK4 sums ((k1 + 2 k2) + 2 k3) + k4, a cost
// sums its terms left to right.

#pragma once

#include "duals.cuh"

namespace {

__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double sin_of(double x) { return sin(x); }
template <typename S>
__device__ __forceinline__ Dual<S> sin_of(Dual<S> x) {
  Dual<S> s, c;
  sin_cos(x, s, c);
  return s;
}
template <typename S>
__device__ __forceinline__ HyperDual<S> sin_of(HyperDual<S> x) {
  HyperDual<S> s, c;
  sin_cos(x, s, c);
  return s;
}

// g / l as ddp_tpu_torch's Pendulum computes it (9.81 / length is torch's
// reciprocal times 9.81)
template <typename S>
__device__ __forceinline__ S g_over(S length) {
  return (S(1) / length) * S(9.81);
}

// One step of the pendulum from x under u: Euler (rk4 == false) or RK4.
template <typename S, typename V>
__device__ __forceinline__ void pendulum_step(bool rk4, S g_over_l, S mass, S dt, const V* x,
                                              const V* u, V* xn) {
  const V ug = u[0] / mass;
  auto accel = [&](V q) { return V(-g_over_l) * sin_of(q) + ug; };
  const V q0 = x[0], v0 = x[1];
  if (!rk4) {
    const V a = accel(q0);
    xn[0] = q0 + V(dt) * v0;
    xn[1] = v0 + V(dt) * a;
    return;
  }
  const V h(S(0.5) * dt), two(S(2));
  const V k1q = v0, k1v = accel(q0);
  const V k2q = v0 + h * k1v, k2v = accel(q0 + h * k1q);
  const V k3q = v0 + h * k2v, k3v = accel(q0 + h * k2q);
  const V k4q = v0 + V(dt) * k3v, k4v = accel(q0 + V(dt) * k3q);
  const V sixth(dt / S(6));
  xn[0] = q0 + sixth * (((k1q + two * k2q) + two * k3q) + k4q);
  xn[1] = v0 + sixth * (((k1v + two * k2v) + two * k3v) + k4v);
}

// constants of each cost kind, as kernels/flat_problem.py's COST_SIZES
constexpr int cost_size(int cost) { return cost == 0 ? 1 : cost == 1 ? 7 : 6; }

template <typename S, int DYN, int COST, int E>
struct PendulumClass {
  static_assert(DYN == 0 || DYN == 1, "integrator: 0 Euler, 1 RK4");
  static_assert(COST >= 0 && COST <= 2, "cost: 0 control, 1 tracking, 2 manifold tracking");
  static constexpr int NX = 2;
  static constexpr int M = 1;
  static constexpr int NE = E;
  static constexpr int NW = cost_size(COST);
  const S* consts;  // the whole buffer: layer and data offsets are absolute
  const S* con;     // its constraint block: n_leaves, then 5 slots a leaf
  S mass, g_over_l, dt;
  S w[NW];  // the cost's constants

  __device__ explicit PendulumClass(const S* consts_)
      : consts(consts_), con(consts_ + 3 + NW), mass(consts_[0]), g_over_l(g_over(consts_[1])),
        dt(consts_[2]) {
    for (int i = 0; i < NW; ++i) w[i] = consts_[3 + i];
  }

  template <typename V>
  __device__ __forceinline__ void dynamics(const V* x, const V* u, V* xn) const {
    pendulum_step<S, V>(DYN == 1, g_over_l, mass, dt, x, u, xn);
  }

  template <typename V>
  __device__ __forceinline__ V stage(const V* x, const V* u) const {
    const V half(S(0.5));
    if constexpr (COST == 0) {
      return V(S(0.5) * w[0]) * (u[0] * u[0]);
    } else if constexpr (COST == 1) {  // x_ref[2], q_diag[2], r_diag, qf_diag[2]
      const V e0 = x[0] - V(w[0]), e1 = x[1] - V(w[1]);
      return half * ((e0 * V(w[2])) * e0 + (e1 * V(w[3])) * e1) + half * ((u[0] * V(w[4])) * u[0]);
    } else {  // x_ref[2], q_diag, v_diag, r_diag, terminal_scale
      const V dq = x[0] - V(w[0]), dv = x[1] - V(w[1]);
      return (half * ((dq * V(w[2])) * dq) + half * ((dv * V(w[3])) * dv)) +
             half * ((u[0] * V(w[4])) * u[0]);
    }
  }

  template <typename V>
  __device__ __forceinline__ V terminal(const V* x) const {
    const V half(S(0.5));
    if constexpr (COST == 0) {
      return V(S(0));
    } else if constexpr (COST == 1) {
      const V e0 = x[0] - V(w[0]), e1 = x[1] - V(w[1]);
      return half * ((e0 * V(w[5])) * e0 + (e1 * V(w[6])) * e1);
    } else {
      const V dq = x[0] - V(w[0]), dv = x[1] - V(w[1]);
      return V(w[5]) * (half * ((dq * V(w[2])) * dq) + half * ((dv * V(w[3])) * dv));
    }
  }

  // row r of out, r a run-time index: a compile-time sweep keeps out in
  // registers
  template <typename V>
  __device__ __forceinline__ static void put(V* out, int r, V value) {
    for (int i = 0; i < (E > 0 ? E : 1); ++i)
      if (i == r) out[i] = value;
  }

  // the E rows at step t from (x, u), unmasked
  template <typename V>
  __device__ __forceinline__ void eq(int t, const V* x, const V* u, V* out) const {
    const int n_leaves = static_cast<int>(con[0]);
    int row = 0;
#pragma unroll 1
    for (int l = 0; l < n_leaves; ++l) {
      const S* leaf = con + 1 + 5 * l;
      const int kind = static_cast<int>(leaf[0]), n_layers = static_cast<int>(leaf[1]);
      const S* layer = consts + static_cast<int>(leaf[2]);
      const S* data = consts + static_cast<int>(leaf[3]);
      V y[2] = {x[0], x[1]};
#pragma unroll 1
      for (int i = 0; i < n_layers; ++i, layer += 4) {
        V yn[2];
        pendulum_step<S, V>(layer[0] != S(0), g_over(layer[3]), layer[2], layer[1], y, u, yn);
        y[0] = yn[0];
        y[1] = yn[1];
      }
      if (kind == 1) {  // state target
        put(out, row, y[0] - V(data[0]));
        put(out, row + 1, y[1] - V(data[1]));
        row += 2;
      } else {  // configuration target, or the trajectory's row at t + n_layers
        int k = 0;
        if (kind == 2) {
          const int last = static_cast<int>(leaf[4]) - 1;
          k = t + n_layers < 0 ? 0 : (t + n_layers > last ? last : t + n_layers);
        }
        put(out, row, y[0] - V(data[k]));
        row += 1;
      }
    }
  }
};

}  // namespace
