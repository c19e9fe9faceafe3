// The problem inside the flat-lane kernels (linesearch_flat.cu,
// flat_solve.cu): a problem class is a policy struct of device functions
// templated on the value type V, so the same source gives the value (V = S),
// a first derivative (V = Dual<S>) and a second derivative (V = HyperDual<S>)
// of the dynamics, the costs and the constraint.  The kernels take the policy
// as a template argument; a second problem class is another struct here and
// another instantiation there, not another kernel.
//
// The TPU kernels rebuild the problem's pytree per lane from a packed vector
// and trace its Python methods; here the source is fixed and the problem is
// data: the wrapper (ddp_tpu_torch/kernels/flat_problem.py) recognises the
// class from the Problem's modules and hands over its constants.
//
// A policy offers
//   NX, M        state and control width (vector-space state, nx == ndx)
//   NE           rows of its equality constraint
//   dynamics(x, u, x_next), stage(x, u), terminal(x), eq(x, u, out)
// and none of them depends on the time index.

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

// Class 0: the closed-form pendulum  a = -(g/l) sin q + tau/m  under Euler
// (q' = q + dt v, v' = v + dt a), the cost  l = (c/2)|u|^2, lf = 0,  and the
// constraint  eq = q_k - target  where q_k is the configuration reached from
// (x, u) by `advance` further Euler steps under the same u (a configuration
// target under that many advance-time layers).  Without a constraint the
// kernels are instantiated with E = 0 and never call eq.
// consts: [mass, length, dt, c, target].
template <typename S>
struct PendulumEulerTarget {
  static constexpr int NX = 2;
  static constexpr int M = 1;
  static constexpr int NE = 1;
  static constexpr int N_CONSTS = 5;
  S mass, g_over_l, dt, c, target;
  int advance;

  __device__ PendulumEulerTarget(const S* consts, int advance_)
      : mass(consts[0]), g_over_l(S(9.81) / consts[1]), dt(consts[2]),
        c(consts[3]), target(consts[4]), advance(advance_) {}

  template <typename V>
  __device__ __forceinline__ void dynamics(const V* x, const V* u, V* xn) const {
    const V a = V(-g_over_l) * sin_of(x[0]) + u[0] / mass;
    const V q = x[0] + V(dt) * x[1];
    const V v = x[1] + V(dt) * a;
    xn[0] = q;
    xn[1] = v;
  }

  template <typename V>
  __device__ __forceinline__ V stage(const V* x, const V* u) const {
    return V(S(0.5) * c) * (u[0] * u[0]);
  }

  template <typename V>
  __device__ __forceinline__ V terminal(const V* x) const {
    return V(S(0));
  }

  template <typename V>
  __device__ __forceinline__ void eq(const V* x, const V* u, V* out) const {
    V y[2] = {x[0], x[1]};
#pragma unroll 1
    for (int i = 0; i < advance; ++i) {
      V yn[2];
      dynamics(y, u, yn);
      y[0] = yn[0];
      y[1] = yn[1];
    }
    out[0] = y[0] - V(target);
  }
};

}  // namespace
