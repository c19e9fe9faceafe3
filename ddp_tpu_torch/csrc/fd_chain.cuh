// The rigid-body chain shared by the fd-derivatives kernels (fd_derivs.cu,
// fd_derivs2.cu): the model view over the wrapper's constant buffers and the
// kinematics -> composite bodies -> RNEA chain templated on the value type.
// The value types (Dual, HyperDual) and the unrolled Cholesky of M come from
// duals.cuh.
//
// Everything sits in an anonymous namespace: each .cu that includes this
// header gets its own copy.  Build without --use_fast_math and without -ftz:
// a non-positive pivot must give NaN through sqrt.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "duals.cuh"

namespace {

// ---------------------------------------------------------------- model

template <typename S, int NV>
struct ModelView {
  const int* jtype;   // [NV] 0 revolute, 1 prismatic
  const int* parent;  // [NV]
  const S* axes;      // [NV, 3]
  const S* jp_rot;    // [NV, 3, 3]
  const S* jp_trans;  // [NV, 3]
  const S* inertias;  // [NV, 6, 6]
  const S* gravity;   // [3]
  const S* damping;   // [NV]
  __device__ ModelView(const int* topo, const S* c)
      : jtype(topo), parent(topo + NV), axes(c), jp_rot(c + 3 * NV),
        jp_trans(c + 12 * NV), inertias(c + 15 * NV), gravity(c + 51 * NV),
        damping(c + 51 * NV + 3) {}
};

// a x b for 3-vectors
template <typename V>
__device__ __forceinline__ void cross3(const V* a, const V* b, V* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// y = A x for a row-major 6x6 A
template <typename V>
__device__ __forceinline__ void mat6_vec(const V* A, const V* x, V* y) {
  for (int a = 0; a < 6; ++a) {
    V s = A[a * 6] * x[0];
    for (int k = 1; k < 6; ++k) s = s + A[a * 6 + k] * x[k];
    y[a] = s;
  }
}

// The kinematics -> composite bodies -> RNEA chain in value type V (S for
// the primal alone, Dual<S> for the primal with one tangent direction).
// Fills M[i][j] for every ancestor i of j (i <= j, j included) and zero
// elsewhere in the upper triangle; the lower triangle is NOT written: read
// M[min(i, j)][max(i, j)].  bias = RNEA(q, v, 0) with gravity and damping.
template <typename V, typename S, int NV>
__device__ void chain_M_bias(const ModelView<S, NV>& md, const V* q, const V* v,
                             V (*M)[NV], V* bias) {
  V Rw[NV][9];   // world rotations, row-major
  V pw[NV][3];   // world positions
  V Sw[NV][6];   // world joint subspace columns (angular, linear)
  V IC[NV][36];  // world spatial inertias, then composite inertias
  V vb[NV][6];   // body spatial velocities
  V ab[NV][6];   // body spatial accelerations at zero joint acceleration
  V fb[NV][6];   // body forces, then subtree forces

  for (int i = 0; i < NV; ++i) {
    const S* ax = md.axes + 3 * i;
    const S* Ep = md.jp_rot + 9 * i;
    const S* rp = md.jp_trans + 3 * i;
    // joint transform: E (joint frame -> child body), rj, subspace S
    V E[9], rj[3];
    S s_ang[3], s_lin[3];
    if (md.jtype[i] == 0) {  // revolute: R = I + s K + (1 - c) K^2, E = R^T
      const S K[9] = {S(0), -ax[2], ax[1], ax[2], S(0), -ax[0], -ax[1], ax[0], S(0)};
      S K2[9];
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)
          K2[a * 3 + b] = K[a * 3] * K[b] + K[a * 3 + 1] * K[3 + b] + K[a * 3 + 2] * K[6 + b];
      V s, c;
      sin_cos(q[i], s, c);
      const V omc = V(S(1)) - c;
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)  // E[b][a] = R[a][b]
          E[b * 3 + a] = V(a == b ? S(1) : S(0)) + s * V(K[a * 3 + b]) + omc * V(K2[a * 3 + b]);
      for (int a = 0; a < 3; ++a) {
        rj[a] = V(S(0));
        s_ang[a] = ax[a];
        s_lin[a] = S(0);
      }
    } else {  // prismatic: E = I, rj = q * axis
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) E[a * 3 + b] = V(a == b ? S(1) : S(0));
        rj[a] = q[i] * V(ax[a]);
        s_ang[a] = S(0);
        s_lin[a] = ax[a];
      }
    }
    // compose the fixed placement: Ef = E Ep, r = rp + Ep^T rj
    V Ef[9], r[3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b)
        Ef[a * 3 + b] = E[a * 3] * V(Ep[b]) + E[a * 3 + 1] * V(Ep[3 + b]) + E[a * 3 + 2] * V(Ep[6 + b]);
      r[a] = V(rp[a]) + rj[0] * V(Ep[a]) + rj[1] * V(Ep[3 + a]) + rj[2] * V(Ep[6 + a]);
    }
    const int p = md.parent[i];
    if (p < 0) {  // Rw = Ef^T, pw = r
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) Rw[i][a * 3 + b] = Ef[b * 3 + a];
        pw[i][a] = r[a];
      }
    } else {  // Rw = Rw[p] Ef^T, pw = Rw[p] r + pw[p]
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b)
          Rw[i][a * 3 + b] = Rw[p][a * 3] * Ef[b * 3] + Rw[p][a * 3 + 1] * Ef[b * 3 + 1] +
                             Rw[p][a * 3 + 2] * Ef[b * 3 + 2];
        pw[i][a] = Rw[p][a * 3] * r[0] + Rw[p][a * 3 + 1] * r[1] + Rw[p][a * 3 + 2] * r[2] + pw[p][a];
      }
    }
    // world joint subspace: X_wb S with X_wb = [[R, 0], [p^ R, R]]
    V sa[3], sl[3], pxs[3];
    for (int a = 0; a < 3; ++a) {
      sa[a] = Rw[i][a * 3] * V(s_ang[0]) + Rw[i][a * 3 + 1] * V(s_ang[1]) + Rw[i][a * 3 + 2] * V(s_ang[2]);
      sl[a] = Rw[i][a * 3] * V(s_lin[0]) + Rw[i][a * 3 + 1] * V(s_lin[1]) + Rw[i][a * 3 + 2] * V(s_lin[2]);
    }
    cross3(pw[i], sa, pxs);
    for (int a = 0; a < 3; ++a) {
      Sw[i][a] = sa[a];
      Sw[i][3 + a] = pxs[a] + sl[a];
    }
    // world spatial inertia Iw = X^T I X, X = X_bw = [[R^T, 0], [-R^T p^, R^T]]
    {
      const V ph[9] = {V(S(0)), -pw[i][2], pw[i][1], pw[i][2], V(S(0)), -pw[i][0],
                       -pw[i][1], pw[i][0], V(S(0))};
      V X[36], Y[36];
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) {
          const V rt = Rw[i][b * 3 + a];  // R^T[a][b]
          X[a * 6 + b] = rt;
          X[a * 6 + 3 + b] = V(S(0));
          X[(3 + a) * 6 + 3 + b] = rt;
          // -(R^T p^)[a][b] = -sum_k R[k][a] p^[k][b]
          X[(3 + a) * 6 + b] = -(Rw[i][a] * ph[b] + Rw[i][3 + a] * ph[3 + b] + Rw[i][6 + a] * ph[6 + b]);
        }
      }
      const S* I6 = md.inertias + 36 * i;
      for (int a = 0; a < 6; ++a) {
        for (int b = 0; b < 6; ++b) {
          V s = V(I6[a * 6]) * X[b];
          for (int k = 1; k < 6; ++k) s = s + V(I6[a * 6 + k]) * X[k * 6 + b];
          Y[a * 6 + b] = s;
        }
      }
      for (int a = 0; a < 6; ++a) {
        for (int b = 0; b < 6; ++b) {
          V s = X[a] * Y[b];
          for (int k = 1; k < 6; ++k) s = s + X[k * 6 + a] * Y[k * 6 + b];
          IC[i][a * 6 + b] = s;
        }
      }
    }
    // velocities and bias accelerations down the tree
    V sv[6], psi[6];
    for (int a = 0; a < 6; ++a) {
      sv[a] = Sw[i][a] * v[i];
      vb[i][a] = (p < 0) ? sv[a] : vb[p][a] + sv[a];
    }
    {  // psi = crm(vb) sv = [w x sv_a, vl x sv_a + w x sv_l]
      V t0[3], t1[3], t2[3];
      cross3(vb[i], sv, t0);
      cross3(vb[i] + 3, sv, t1);
      cross3(vb[i], sv + 3, t2);
      for (int a = 0; a < 3; ++a) {
        psi[a] = t0[a];
        psi[3 + a] = t1[a] + t2[a];
      }
    }
    for (int a = 0; a < 6; ++a) {
      const V base = (p < 0) ? V(a < 3 ? S(0) : -md.gravity[a - 3]) : ab[p][a];
      ab[i][a] = base + psi[a];
    }
    // fb = Iw ab - crm(vb)^T (Iw vb);  crm(v)^T u = [-w x u_a - vl x u_l, -w x u_l]
    {
      V Ivb[6], Iab[6], t0[3], t1[3], t2[3];
      mat6_vec(IC[i], vb[i], Ivb);
      mat6_vec(IC[i], ab[i], Iab);
      cross3(vb[i], Ivb, t0);
      cross3(vb[i] + 3, Ivb + 3, t1);
      cross3(vb[i], Ivb + 3, t2);
      for (int a = 0; a < 3; ++a) {
        fb[i][a] = Iab[a] + (t0[a] + t1[a]);
        fb[i][3 + a] = Iab[3 + a] + t2[a];
      }
    }
  }

  // composite inertias and subtree forces up the tree
  for (int i = NV - 1; i >= 0; --i) {
    const int p = md.parent[i];
    if (p >= 0) {
      for (int a = 0; a < 36; ++a) IC[p][a] = IC[p][a] + IC[i][a];
      for (int a = 0; a < 6; ++a) fb[p][a] = fb[p][a] + fb[i][a];
    }
  }
  for (int i = 0; i < NV; ++i)
    for (int j = i; j < NV; ++j) M[i][j] = V(S(0));
  for (int j = 0; j < NV; ++j) {
    V u[6];
    mat6_vec(IC[j], Sw[j], u);
    for (int i = j; i >= 0; i = md.parent[i]) {
      V s = Sw[i][0] * u[0];
      for (int a = 1; a < 6; ++a) s = s + Sw[i][a] * u[a];
      M[i][j] = s;
    }
    V s = V(md.damping[j]) * v[j];
    for (int a = 0; a < 6; ++a) s = s + Sw[j][a] * fb[j][a];
    bias[j] = s;
  }
}


}  // namespace
