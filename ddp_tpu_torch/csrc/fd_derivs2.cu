// Batched SECOND-order forward-dynamics derivatives for tree robots with
// revolute and prismatic joints, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/fd_derivs2.py (_fd2_kernel
// over the second-order duals _D2, launched by fd_derivs2_pallas's
// pl.pallas_call) on the deriv="kernel" path of a second_order problem in
// ddp_tpu_torch.solver.batched.solve_batched.  Per sample (q, v, tau) it
// gives everything fd_derivs.cu gives,
//
//     a = M^-1 (tau - bias),  da/dq,  da/dv,  da/dtau = M^-1,
//
// plus the acceleration Hessian H[o, i, j] = d2 a_o / d zeta_i d zeta_j over
// zeta = (q, v, tau), NZ = 3*NV, from differentiating RNEA(q, v, a) = tau
// implicitly twice against ONE Cholesky factor of M:
//
//     M d_ij a = -[d_ij bias + (d_ij M) a + (d_i M)(d_j a) + (d_j M)(d_i a)]
//     M d_(tau_k) d_s a = -(d_s M)(M^-1 e_k)     (zero for s over v: M = M(q))
//     d_tau d_tau' a = 0
//
// The TPU kernel keeps a whole sparse second-order dual (2*NV gradient and
// NV*(2*NV+1) Hessian entries per scalar) of the chain live per lane, which
// no CUDA thread can hold.  Here the grid is (samples, pairs + 1): a thread
// carries ONE pair (i <= j) of the 2*NV (q, v) directions through the chain
// (fd_chain.cuh) as a hyper-dual number (p, d_i, d_j, d_ij) - four scalars a
// value, twice fd_derivs.cu's state - factors M, solves for a, d_i a, d_j a
// and then for H[:, i, j], which it writes to both triangles from the same
// value, so H is exactly symmetric.  A diagonal pair (i == j) also writes
// column i of da/dq or da/dv and the tau cross block of direction i (exact
// zeros for a v direction).  The last row of blocks runs the chain without
// tangents and writes a, M^-1 and the zero tau-tau block.  At NV = 7 that is
// 105 + 1 threads a sample; the primal chain and the factor are repeated in
// every one of them.
//
// Layout: input [3*NV, N], outputs [NV, N], three [NV*NV, N] and H
// [NV*NZ*NZ, N] with row (o*NZ + i)*NZ + j, the sample last, so every load
// and store is coalesced across a warp.  Any N; the ragged edge is masked.
//
// Bound: H is NV*NZ*NZ values a sample (3,087 at NV = 7; 50.6 MB at N = 4096
// in float), so the bytes written bound the function at about 16 us there,
// near its operations' time at the float peak; in practice local-memory
// traffic binds, as in fd_derivs.cu: the per-body arrays are indexed with
// run-time parents and live in local memory, here at twice the size.
//
// Build without --use_fast_math and without -ftz: a non-positive pivot must
// give NaN through sqrt, as in the plain version.

#include <cuda_runtime.h>

#include <cstddef>

#include "fd_chain.cuh"

namespace {

template <typename S, int NV>
__global__ void __launch_bounds__(64) fd_derivs2_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts,
    const S* __restrict__ qvu, S* __restrict__ a_out, S* __restrict__ Aq,
    S* __restrict__ Av, S* __restrict__ Mi, S* __restrict__ H, int N) {
  constexpr int NC = 2 * NV;              // seed space (q, v)
  constexpr int NZ = 3 * NV;              // Hessian space (q, v, tau)
  constexpr int NP = NC * (NC + 1) / 2;   // pairs i <= j
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int pidx = blockIdx.y;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  auto hstore = [&](int o, int r, int c, S val) {
    H[(static_cast<size_t>(o * NZ + r) * NZ + c) * Ns + n] = val;
  };

  S q[NV], v[NV], tau[NV];
  for (int k = 0; k < NV; ++k) {
    q[k] = qvu[k * Ns + n];
    v[k] = qvu[(NV + k) * Ns + n];
    tau[k] = qvu[(2 * NV + k) * Ns + n];
  }

  S L[NV][NV], a[NV];
  if (pidx < NP) {
    // pair (i, j), i <= j, row-major over the upper triangle
    int i = 0, rem = pidx;
    while (rem >= NC - i) {
      rem -= NC - i;
      ++i;
    }
    const int j = i + rem;

    using HD = HyperDual<S>;
    HD qd[NV], vd[NV], M[NV][NV], bias[NV];
    for (int k = 0; k < NV; ++k) {
      qd[k] = HD(q[k], i == k ? S(1) : S(0), j == k ? S(1) : S(0), S(0));
      vd[k] = HD(v[k], i == NV + k ? S(1) : S(0), j == NV + k ? S(1) : S(0), S(0));
    }
    chain_M_bias<HD, S, NV>(md, qd, vd, M, bias);
    for (int r = 0; r < NV; ++r) {
      for (int c = 0; c <= r; ++c) L[r][c] = M[c][r].p;
      a[r] = tau[r] - bias[r].p;
    }
    chol_factor<S, NV>(L);
    chol_apply<S, NV>(L, a);

    // first order: d_i a = -M^-1 (d_i bias + (d_i M) a), and the same for j
    S di[NV], dj[NV];
    for (int r = 0; r < NV; ++r) {
      S si = bias[r].t1, sj = bias[r].t2;
      for (int c = 0; c < NV; ++c) {
        const HD& m = (r <= c) ? M[r][c] : M[c][r];
        si = si + m.t1 * a[c];
        sj = sj + m.t2 * a[c];
      }
      di[r] = -si;
      dj[r] = -sj;
    }
    chol_apply<S, NV>(L, di);
    chol_apply<S, NV>(L, dj);

    // second order
    S hh[NV];
    for (int r = 0; r < NV; ++r) {
      S s = bias[r].h;
      for (int c = 0; c < NV; ++c) {
        const HD& m = (r <= c) ? M[r][c] : M[c][r];
        s = s + m.h * a[c] + m.t1 * dj[c] + m.t2 * di[c];
      }
      hh[r] = -s;
    }
    chol_apply<S, NV>(L, hh);
    for (int o = 0; o < NV; ++o) {
      hstore(o, i, j, hh[o]);
      if (i != j) hstore(o, j, i, hh[o]);
    }

    if (i == j) {
      // column i of da/dq or da/dv
      S* dst = (i < NV) ? Aq : Av;
      const int cc = (i < NV) ? i : i - NV;
      for (int o = 0; o < NV; ++o) dst[(o * NV + cc) * Ns + n] = di[o];
      // tau cross block of direction i: -M^-1 (d_i M) M^-1 e_k; M does not
      // depend on v, so a v direction's block is exactly zero
      for (int k = 0; k < NV; ++k) {
        S col[NV];
        if (i < NV) {
          S mk[NV];
          for (int r = 0; r < NV; ++r) mk[r] = (r == k) ? S(1) : S(0);
          chol_apply<S, NV>(L, mk);
          for (int r = 0; r < NV; ++r) {
            S s = S(0);
            for (int c = 0; c < NV; ++c)
              s = s + ((r <= c) ? M[r][c].t1 : M[c][r].t1) * mk[c];
            col[r] = -s;
          }
          chol_apply<S, NV>(L, col);
        } else {
          for (int r = 0; r < NV; ++r) col[r] = S(0);
        }
        for (int o = 0; o < NV; ++o) {
          hstore(o, NC + k, i, col[o]);
          hstore(o, i, NC + k, col[o]);
        }
      }
    }
  } else {
    S M[NV][NV], bias[NV];
    chain_M_bias<S, S, NV>(md, q, v, M, bias);
    for (int r = 0; r < NV; ++r) {
      for (int c = 0; c <= r; ++c) L[r][c] = M[c][r];
      a[r] = tau[r] - bias[r];
    }
    chol_factor<S, NV>(L);
    chol_apply<S, NV>(L, a);
    for (int r = 0; r < NV; ++r) a_out[r * Ns + n] = a[r];
    for (int k = 0; k < NV; ++k) {
      S col[NV];
      for (int r = 0; r < NV; ++r) col[r] = (r == k) ? S(1) : S(0);
      chol_apply<S, NV>(L, col);
      for (int r = 0; r < NV; ++r) Mi[(r * NV + k) * Ns + n] = col[r];
    }
    // a is affine in tau: the tau-tau block is exactly zero
    for (int o = 0; o < NV; ++o)
      for (int k = 0; k < NV; ++k)
        for (int k2 = 0; k2 < NV; ++k2) hstore(o, NC + k, NC + k2, S(0));
  }
}

template <typename S, int NV>
int launch(const void* topo, const void* consts, const void* qvu, void* a,
           void* Aq, void* Av, void* Mi, void* H, int N, cudaStream_t stream) {
  const int threads = 64;
  const dim3 grid((N + threads - 1) / threads, NV * (2 * NV + 1) + 1);
  fd_derivs2_kernel<S, NV><<<grid, threads, 0, stream>>>(
      static_cast<const int*>(topo), static_cast<const S*>(consts),
      static_cast<const S*>(qvu), static_cast<S*>(a), static_cast<S*>(Aq),
      static_cast<S*>(Av), static_cast<S*>(Mi), static_cast<S*>(H), N);
  return static_cast<int>(cudaGetLastError());
}

template <int NV>
int launch_dtype(int is_double, const void* topo, const void* consts,
                 const void* qvu, void* a, void* Aq, void* Av, void* Mi,
                 void* H, int N, cudaStream_t s) {
  return is_double ? launch<double, NV>(topo, consts, qvu, a, Aq, Av, Mi, H, N, s)
                   : launch<float, NV>(topo, consts, qvu, a, Aq, Av, Mi, H, N, s);
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``topo``, ``consts`` and
// ``qvu`` are ddp_fd_derivs's (fd_derivs.cu); ``H`` is [nv*(3nv)*(3nv), N].
// Returns cudaGetLastError() after the launch; -1 for an nv this build does
// not instantiate.
extern "C" int ddp_fd_derivs2(int is_double, int nv, int N, const void* topo,
                              const void* consts, const void* qvu, void* a,
                              void* Aq, void* Av, void* Mi, void* H,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;  // an empty grid is not a valid launch
  if (nv == 2) return launch_dtype<2>(is_double, topo, consts, qvu, a, Aq, Av, Mi, H, N, s);
  if (nv == 6) return launch_dtype<6>(is_double, topo, consts, qvu, a, Aq, Av, Mi, H, N, s);
  if (nv == 7) return launch_dtype<7>(is_double, topo, consts, qvu, a, Aq, Av, Mi, H, N, s);
  return -1;
}
