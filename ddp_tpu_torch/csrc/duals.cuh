// Small numerics shared by the port's CUDA kernels: forward-mode value types
// (Dual: one tangent; HyperDual: two tangents and their mixed second
// derivative) with sin_cos and root overloads, and the unrolled Cholesky of a
// small symmetric matrix.
//
// Everything sits in an anonymous namespace: each .cu that includes this
// header gets its own copy.  Build without --use_fast_math and without -ftz:
// a non-positive pivot must give NaN through sqrt.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

// ---------------------------------------------------------------- duals

template <typename S>
struct Dual {
  S p, t;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(S p_) : p(p_), t(S(0)) {}
  __device__ __forceinline__ Dual(S p_, S t_) : p(p_), t(t_) {}
  friend __device__ __forceinline__ Dual operator+(Dual a, Dual b) {
    return Dual(a.p + b.p, a.t + b.t);
  }
  friend __device__ __forceinline__ Dual operator-(Dual a, Dual b) {
    return Dual(a.p - b.p, a.t - b.t);
  }
  friend __device__ __forceinline__ Dual operator-(Dual a) {
    return Dual(-a.p, -a.t);
  }
  friend __device__ __forceinline__ Dual operator*(Dual a, Dual b) {
    return Dual(a.p * b.p, a.t * b.p + a.p * b.t);
  }
  // a value over a constant
  friend __device__ __forceinline__ Dual operator/(Dual a, S b) {
    return Dual(a.p / b, a.t / b);
  }
};

__device__ __forceinline__ void sin_cos(float x, float& s, float& c) { sincosf(x, &s, &c); }
__device__ __forceinline__ void sin_cos(double x, double& s, double& c) { sincos(x, &s, &c); }
template <typename S>
__device__ __forceinline__ void sin_cos(Dual<S> x, Dual<S>& s, Dual<S>& c) {
  S sp, cp;
  sin_cos(x.p, sp, cp);
  s = Dual<S>(sp, cp * x.t);
  c = Dual<S>(cp, -sp * x.t);
}

// A value with two tangent directions and their mixed second derivative:
// (p, d_1, d_2, d_1 d_2).  Seeding both directions on one variable gives its
// pure second derivative in h.
template <typename S>
struct HyperDual {
  S p, t1, t2, h;
  __device__ __forceinline__ HyperDual() {}
  __device__ __forceinline__ HyperDual(S p_) : p(p_), t1(S(0)), t2(S(0)), h(S(0)) {}
  __device__ __forceinline__ HyperDual(S p_, S t1_, S t2_, S h_)
      : p(p_), t1(t1_), t2(t2_), h(h_) {}
  friend __device__ __forceinline__ HyperDual operator+(HyperDual a, HyperDual b) {
    return HyperDual(a.p + b.p, a.t1 + b.t1, a.t2 + b.t2, a.h + b.h);
  }
  friend __device__ __forceinline__ HyperDual operator-(HyperDual a, HyperDual b) {
    return HyperDual(a.p - b.p, a.t1 - b.t1, a.t2 - b.t2, a.h - b.h);
  }
  friend __device__ __forceinline__ HyperDual operator-(HyperDual a) {
    return HyperDual(-a.p, -a.t1, -a.t2, -a.h);
  }
  friend __device__ __forceinline__ HyperDual operator*(HyperDual a, HyperDual b) {
    return HyperDual(a.p * b.p, a.t1 * b.p + a.p * b.t1, a.t2 * b.p + a.p * b.t2,
                     a.h * b.p + a.t1 * b.t2 + a.t2 * b.t1 + a.p * b.h);
  }
  // a value over a constant
  friend __device__ __forceinline__ HyperDual operator/(HyperDual a, S b) {
    return HyperDual(a.p / b, a.t1 / b, a.t2 / b, a.h / b);
  }
};

template <typename S>
__device__ __forceinline__ void sin_cos(HyperDual<S> x, HyperDual<S>& s, HyperDual<S>& c) {
  S sp, cp;
  sin_cos(x.p, sp, cp);
  const S tt = x.t1 * x.t2;
  s = HyperDual<S>(sp, cp * x.t1, cp * x.t2, cp * x.h - sp * tt);
  c = HyperDual<S>(cp, -sp * x.t1, -sp * x.t2, -sp * x.h - cp * tt);
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// ---------------------------------------------------------------- Cholesky

// In-place Cholesky-Banachiewicz of the symmetric L (lower triangle read and
// written).  A non-positive pivot gives NaN.
template <typename S, int NV>
__device__ __forceinline__ void chol_factor(S (*L)[NV]) {
  for (int i = 0; i < NV; ++i) {
    for (int j = 0; j <= i; ++j) {
      S s = L[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? root(s) : s / L[j][j];
    }
  }
}

// x <- (L L^T)^-1 x
template <typename S, int NV>
__device__ __forceinline__ void chol_apply(const S (*L)[NV], S* x) {
  for (int i = 0; i < NV; ++i) {
    S s = x[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * x[k];
    x[i] = s / L[i][i];
  }
  for (int i = NV - 1; i >= 0; --i) {
    S s = x[i];
    for (int k = i + 1; k < NV; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

}  // namespace
