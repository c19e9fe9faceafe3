// Batched forward-dynamics derivative blocks for tree robots with revolute
// and prismatic joints, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/fd_derivs.py
// (_fd_kernel over _chain_M_bias, launched by fd_derivs_pallas's
// pl.pallas_call) on the deriv="kernel" path of
// ddp_tpu_torch.solver.batched.solve_batched.  Per sample (q, v, tau):
//
//     a      = M^-1 (tau - bias)            bias = RNEA(q, v, 0)
//     da/dq  = -M^-1 (d_q bias + (d_q M) a)
//     da/dv  = -M^-1  d_v bias
//     da/dtau = M^-1
//
// The chain: world kinematics (Rodrigues rotation per revolute joint, fixed
// placement, parent chain), world spatial inertias X^T I X, composite bodies
// for M, RNEA with gravity and damping for the bias, one Cholesky of M (IEEE
// sqrt), then forward/backward substitutions against that factor.
//
// The model is DATA, not code: one source serves every model with NV joints.
// ``topo`` holds joint types (0 revolute, 1 prismatic) and parents (a parent
// precedes its children; -1 for a root), ``consts`` the axes, placements,
// spatial inertias, gravity and damping; all threads read the same addresses,
// which the cache broadcasts.
//
// Layout: input [3*NV, N] (q rows, v rows, tau rows), outputs [NV, N] and
// three [NV*NV, N] with matrices flattened row-major, the sample last, so
// loads and stores are coalesced across a warp.  Any N; the ragged edge is
// masked.
//
// Work split: thread (sample n, blockIdx.y = c).  For c < 2*NV the thread
// carries ONE tangent direction (column c of (q, v)) through the chain in
// dual numbers, factors M, solves for a and for column c of da/dq or da/dv.
// For c == 2*NV it runs the chain without tangents and writes a and M^-1.
// A dense 2*NV-column dual of the chain state (about 600 scalars at NV = 7)
// would need about 9,000 scalars a thread; one direction a thread keeps the
// state at twice the primal and makes the grid (2*NV + 1) times wider, which
// a batch of a few thousand samples needs anyway to fill 132 SMs.  The price
// is that the primal chain and the factorization are repeated in every
// direction's thread.
//
// Bound: operations (about 2*NV+1 chains of some 10^4 flops per sample
// against 4*(4*NV + 3*NV^2) bytes), and in practice local-memory traffic:
// the tree is walked with run-time parent indices, so the per-body arrays
// live in local memory, not registers.
//
// Build without --use_fast_math and without -ftz: a non-positive pivot must
// give NaN through sqrt, as in the plain version.

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

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

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

// ---------------------------------------------------------------- kernel

template <typename S, int NV>
__global__ void __launch_bounds__(64) fd_derivs_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts,
    const S* __restrict__ qvu, S* __restrict__ a_out, S* __restrict__ Aq,
    S* __restrict__ Av, S* __restrict__ Mi, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int c = blockIdx.y;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);

  S q[NV], v[NV], tau[NV];
  for (int i = 0; i < NV; ++i) {
    q[i] = qvu[i * Ns + n];
    v[i] = qvu[(NV + i) * Ns + n];
    tau[i] = qvu[(2 * NV + i) * Ns + n];
  }

  S L[NV][NV], a[NV];
  if (c < 2 * NV) {
    Dual<S> qd[NV], vd[NV], M[NV][NV], bias[NV];
    for (int i = 0; i < NV; ++i) {
      qd[i] = Dual<S>(q[i], c == i ? S(1) : S(0));
      vd[i] = Dual<S>(v[i], c == NV + i ? S(1) : S(0));
    }
    chain_M_bias<Dual<S>, S, NV>(md, qd, vd, M, bias);
    for (int i = 0; i < NV; ++i) {
      for (int j = 0; j <= i; ++j) L[i][j] = M[j][i].p;
      a[i] = tau[i] - bias[i].p;
    }
    chol_factor<S, NV>(L);
    chol_apply<S, NV>(L, a);
    // rhs = -(d bias + (dM) a), column c of da/d(q, v) = M^-1 rhs
    S col[NV];
    for (int i = 0; i < NV; ++i) {
      S s = bias[i].t;
      for (int j = 0; j < NV; ++j) s = s + (i <= j ? M[i][j].t : M[j][i].t) * a[j];
      col[i] = -s;
    }
    chol_apply<S, NV>(L, col);
    S* dst = (c < NV) ? Aq : Av;
    const int cc = (c < NV) ? c : c - NV;
    for (int i = 0; i < NV; ++i) dst[(i * NV + cc) * Ns + n] = col[i];
  } else {
    S M[NV][NV], bias[NV];
    chain_M_bias<S, S, NV>(md, q, v, M, bias);
    for (int i = 0; i < NV; ++i) {
      for (int j = 0; j <= i; ++j) L[i][j] = M[j][i];
      a[i] = tau[i] - bias[i];
    }
    chol_factor<S, NV>(L);
    chol_apply<S, NV>(L, a);
    for (int i = 0; i < NV; ++i) a_out[i * Ns + n] = a[i];
    for (int cc = 0; cc < NV; ++cc) {
      S col[NV];
      for (int i = 0; i < NV; ++i) col[i] = (i == cc) ? S(1) : S(0);
      chol_apply<S, NV>(L, col);
      for (int i = 0; i < NV; ++i) Mi[(i * NV + cc) * Ns + n] = col[i];
    }
  }
}

template <typename S, int NV>
int launch(const void* topo, const void* consts, const void* qvu, void* a,
           void* Aq, void* Av, void* Mi, int N, cudaStream_t stream) {
  const int threads = 64;
  const dim3 grid((N + threads - 1) / threads, 2 * NV + 1);
  fd_derivs_kernel<S, NV><<<grid, threads, 0, stream>>>(
      static_cast<const int*>(topo), static_cast<const S*>(consts),
      static_cast<const S*>(qvu), static_cast<S*>(a), static_cast<S*>(Aq),
      static_cast<S*>(Av), static_cast<S*>(Mi), N);
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_dtype(int is_double, const void* topo, const void* consts,
                 const void* qvu, void* a, void* Aq, void* Av, void* Mi, int N,
                 cudaStream_t s) {
  return is_double ? launch<double, NV>(topo, consts, qvu, a, Aq, Av, Mi, N, s)
                   : launch<float, NV>(topo, consts, qvu, a, Aq, Av, Mi, N, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``topo`` is int32 [2*nv]
// (joint types, parents); ``consts`` is [51*nv + 3 + nv] of the working type
// (axes, jp_rot, jp_trans, inertias, gravity, damping); ``qvu`` is
// [3*nv, N].  Returns cudaGetLastError() after the launch; -1 for an nv this
// build does not instantiate.
extern "C" int ddp_fd_derivs(int is_double, int nv, int N, const void* topo,
                             const void* consts, const void* qvu, void* a,
                             void* Aq, void* Av, void* Mi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;  // an empty grid is not a valid launch
  if (nv == 2) return launch_dtype<2>(is_double, topo, consts, qvu, a, Aq, Av, Mi, N, s);
  if (nv == 6) return launch_dtype<6>(is_double, topo, consts, qvu, a, Aq, Av, Mi, N, s);
  if (nv == 7) return launch_dtype<7>(is_double, topo, consts, qvu, a, Aq, Av, Mi, N, s);
  return -1;
}
