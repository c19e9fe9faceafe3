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
// The call runs in two passes, sample last in every array:
//
//   1. the primal pass, a thread per sample, runs the chain once in plain
//      numbers and factors M once: it writes a, M^-1 (one column per unit
//      vector solved against the factor), the factor itself (packed lower
//      triangle, a buffer of the wrapper's) and the exact zeros of the
//      tau-tau block;
//   2. the pair passes, a thread per sample and pair i <= j of the 2*NV
//      (q, v) directions, one launch per kind of pair so that each compiles
//      with only the arrays of its own chain.  A block is 64 samples of one
//      pair, so its threads never diverge.  Each reads the primal pass's
//      factor and a, carries its pair through the chain as a hyper-dual
//      number (p, d_i, d_j, d_ij), solves for d_i a, d_j a and then H[:, i, j]
//      against the shared factor, and writes H to both triangles from the same
//      value, so H is exactly symmetric.  What a pair carries follows what
//      depends on it (fd_chain.cuh's chain in three pieces): M and the
//      kinematics depend on q alone, so a (q, q) pair runs the whole chain in
//      hyper-duals, a (q, v) pair the kinematics and M in the q tangent alone
//      (Dual) and only the RNEA half in hyper-duals, and a (v, v) pair the
//      kinematics in plain numbers and the RNEA half in hyper-duals, with no
//      M at all.  At NV = 7 that is 28 hyper-dual chains, 49 Dual chains and
//      77 hyper-dual RNEA halves a sample and one factorization.  A diagonal
//      pair (i == j) also writes column i of da/dq or da/dv and the tau cross
//      block of direction i, -M^-1 (d_i M) M^-1 e_k from the primal pass's
//      M^-1 (exact zeros for a v direction: M = M(q)).
//
// Layout: input [3*NV, N], outputs [NV, N], three [NV*NV, N] and H
// [NV*NZ*NZ, N] with row (o*NZ + i)*NZ + j, the factor [NV*(NV+1)/2, N], so
// every load and store is coalesced across a warp.  Any N; the ragged edge is
// masked.
//
// Bound: the function's operations, about 1.36 Mflop a sample at NV = 7
// (chip_smoke.py's fd2_flops), at the float peak: 83 us at N = 4096; the
// bytes of H (50.6 MB in float) take 16 us.  In practice the chain's
// per-body arrays, indexed with run-time parents, live in local memory.
//
// Build without --use_fast_math and without -ftz: a non-positive pivot must
// give NaN through sqrt, as in the plain version.
//
// Keep chip_smoke.py's fd2 cases after any change here: nvcc (12.9, -O3)
// gave wrong hyper-dual second derivatives (right primal and first-order
// parts) for two other arrangements of this chain, a block per sample sharing
// the primal through shared memory and a pair thread with its chain out of
// line.  Built for the host with tests/cuda_host's harness under g++ -O2/-O3
// with AddressSanitizer and UndefinedBehaviorSanitizer, and with every local
// initialised to a pattern, both are right and clean: no source defect is
// known.

#include <cuda_runtime.h>

#include <cstddef>

#include "fd_chain.cuh"

namespace {

// the kinds of pair, a template argument of the pair passes
constexpr int QQ = 0, QV = 1, VV = 2;

// pairs of a kind: (q, q) and (v, v) over the upper triangle i <= j of NV
// indices, (q, v) over all NV * NV
template <int K, int NV>
constexpr int pair_count() {
  return K == QV ? NV * NV : NV * (NV + 1) / 2;
}

// the primal pass: a, M^-1, the factor of M and the tau-tau zeros
template <typename S, int NV>
__global__ void __launch_bounds__(64) fd2_primal_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts, const S* __restrict__ qvu,
    S* __restrict__ a_out, S* __restrict__ Mi, S* __restrict__ Lf, S* __restrict__ H, int N) {
  constexpr int NZ = 3 * NV;
  constexpr int NC = 2 * NV;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  S q[NV], v[NV], M[NV][NV], bias[NV], L[NV][NV], a[NV];
  for (int k = 0; k < NV; ++k) {
    q[k] = qvu[k * Ns + n];
    v[k] = qvu[(NV + k) * Ns + n];
  }
  chain_M_bias<S, S, NV>(md, q, v, M, bias);
  for (int r = 0; r < NV; ++r) {
    for (int c = 0; c <= r; ++c) L[r][c] = M[c][r];
    a[r] = qvu[(2 * NV + r) * Ns + n] - bias[r];
  }
  chol_factor<S, NV>(L);
  chol_apply<S, NV>(L, a);
  for (int r = 0; r < NV; ++r) {
    a_out[r * Ns + n] = a[r];
    for (int c = 0; c <= r; ++c) Lf[(r * (r + 1) / 2 + c) * Ns + n] = L[r][c];
  }
  for (int k = 0; k < NV; ++k) {
    S col[NV];
    for (int r = 0; r < NV; ++r) col[r] = (r == k) ? S(1) : S(0);
    chol_apply<S, NV>(L, col);
    for (int r = 0; r < NV; ++r) Mi[(r * NV + k) * Ns + n] = col[r];
  }
  // a is affine in tau: the tau-tau block is exactly zero
  for (int o = 0; o < NV; ++o)
    for (int k = 0; k < NV; ++k)
      for (int k2 = 0; k2 < NV; ++k2)
        H[(static_cast<size_t>(o * NZ + NC + k) * NZ + NC + k2) * Ns + n] = S(0);
}

// the pair passes: a thread per sample and pair of kind K
template <typename S, int NV, int K>
__global__ void __launch_bounds__(64) fd2_pair_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts, const S* __restrict__ qvu,
    const S* __restrict__ a_in, const S* __restrict__ Mi, const S* __restrict__ Lf,
    S* __restrict__ Aq, S* __restrict__ Av, S* __restrict__ H, int N) {
  using HD = HyperDual<S>;
  using D = Dual<S>;
  constexpr int NZ = 3 * NV;  // Hessian space (q, v, tau)
  constexpr int NC = 2 * NV;  // seed space (q, v)
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  auto hstore = [&](int o, int r, int c, S val) {
    H[(static_cast<size_t>(o * NZ + r) * NZ + c) * Ns + n] = val;
  };
  // the pair (i, j), i <= j, as indices into (q, v)
  int i, j;
  if (K == QV) {
    i = blockIdx.y / NV;
    j = NV + blockIdx.y % NV;
  } else {
    int rem = blockIdx.y;
    i = 0;
    while (rem >= NV - i) {
      rem -= NV - i;
      ++i;
    }
    j = i + rem;
    if (K == VV) i += NV, j += NV;
  }

  S q[NV], v[NV], L[NV][NV], a[NV];
  for (int k = 0; k < NV; ++k) {
    q[k] = qvu[k * Ns + n];
    v[k] = qvu[(NV + k) * Ns + n];
    a[k] = a_in[k * Ns + n];
  }
  for (int r = 0; r < NV; ++r)
    for (int c = 0; c <= r; ++c) L[r][c] = Lf[(r * (r + 1) / 2 + c) * Ns + n];

  // d_i M (q_i directions; upper triangle), d_j M and d_ij M ((q, q) pairs),
  // and bias in hyper-duals; the right-hand sides
  //   d_i a = -M^-1 (d_i bias + (d_i M) a), the same for j,
  //   d_ij a = -M^-1 (d_ij bias + (d_ij M) a + (d_i M) d_j a + (d_j M) d_i a)
  S di[NV], dj[NV], hh[NV], dMi[NV][NV];
  HD bias[NV];
  if constexpr (K == QQ) {
    HD qd[NV], vd[NV], M[NV][NV];
    for (int k = 0; k < NV; ++k) {
      qd[k] = HD(q[k], i == k ? S(1) : S(0), j == k ? S(1) : S(0), S(0));
      vd[k] = HD(v[k]);
    }
    chain_M_bias<HD, S, NV>(md, qd, vd, M, bias);
    for (int r = 0; r < NV; ++r) {
      S si = bias[r].t1, sj = bias[r].t2;
      for (int c = 0; c < NV; ++c) {
        const HD& m = (r <= c) ? M[r][c] : M[c][r];
        dMi[r][c] = m.t1;
        si = si + m.t1 * a[c];
        sj = sj + m.t2 * a[c];
      }
      di[r] = -si;
      dj[r] = -sj;
    }
    chol_apply<S, NV>(L, di);
    chol_apply<S, NV>(L, dj);
    for (int r = 0; r < NV; ++r) {
      S s = bias[r].h;
      for (int c = 0; c < NV; ++c) {
        const HD& m = (r <= c) ? M[r][c] : M[c][r];
        s = s + m.h * a[c] + m.t1 * dj[c] + m.t2 * di[c];
      }
      hh[r] = -s;
    }
  } else if constexpr (K == QV) {  // kinematics and M in the q_i tangent
    D qd[NV], Sw[NV][6], IC[NV][36], Md[NV][NV];
    HD vd[NV];
    for (int k = 0; k < NV; ++k) {
      qd[k] = D(q[k], i == k ? S(1) : S(0));
      vd[k] = HD(v[k], S(0), j == NV + k ? S(1) : S(0), S(0));
    }
    chain_kinematics<D, S, NV>(md, qd, Sw, IC);
    chain_bias<HD, S, NV>(
        md, vd, [&](int b, int c) { return HD(Sw[b][c].p, Sw[b][c].t, S(0), S(0)); },
        [&](int b, int c) { return HD(IC[b][c].p, IC[b][c].t, S(0), S(0)); }, bias);
    chain_mass<D, S, NV>(md, Sw, IC, Md);
    for (int r = 0; r < NV; ++r) {
      S si = bias[r].t1;
      for (int c = 0; c < NV; ++c) {
        dMi[r][c] = (r <= c) ? Md[r][c].t : Md[c][r].t;
        si = si + dMi[r][c] * a[c];
      }
      di[r] = -si;
      dj[r] = -bias[r].t2;  // d_v M = 0
    }
    chol_apply<S, NV>(L, di);
    chol_apply<S, NV>(L, dj);
    for (int r = 0; r < NV; ++r) {
      S s = bias[r].h;
      for (int c = 0; c < NV; ++c) s = s + dMi[r][c] * dj[c];
      hh[r] = -s;
    }
  } else {  // (v_i, v_j): kinematics in plain numbers, no M
    S Sw[NV][6], IC[NV][36];
    HD vd[NV];
    for (int k = 0; k < NV; ++k)
      vd[k] = HD(v[k], i == NV + k ? S(1) : S(0), j == NV + k ? S(1) : S(0), S(0));
    chain_kinematics<S, S, NV>(md, q, Sw, IC);
    chain_bias<HD, S, NV>(
        md, vd, [&](int b, int c) { return HD(Sw[b][c]); }, [&](int b, int c) { return HD(IC[b][c]); },
        bias);
    for (int r = 0; r < NV; ++r) {
      di[r] = -bias[r].t1;
      hh[r] = -bias[r].h;
    }
    chol_apply<S, NV>(L, di);
  }
  chol_apply<S, NV>(L, hh);
  for (int o = 0; o < NV; ++o) {
    hstore(o, i, j, hh[o]);
    if (i != j) hstore(o, j, i, hh[o]);
  }

  if (i == j) {
    // column i of da/dq or da/dv
    S* dst = (K == QQ) ? Aq : Av;
    const int cc = (K == QQ) ? i : i - NV;
    for (int o = 0; o < NV; ++o) dst[(o * NV + cc) * Ns + n] = di[o];
    // tau cross block of direction i: -M^-1 (d_i M) M^-1 e_k; M does not
    // depend on v, so a v direction's block is exactly zero
    for (int k = 0; k < NV; ++k) {
      S col[NV];
      if constexpr (K == QQ) {
        for (int r = 0; r < NV; ++r) {
          S s = S(0);
          for (int c = 0; c < NV; ++c) s = s + dMi[r][c] * Mi[(c * NV + k) * Ns + n];
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
}

// ------------------------------------------------------------ launch

// One library serves one joint count, both value types: kernels/_build.py
// compiles this file with -DDDP_NV=nv for the model of the call.
#ifndef DDP_NV
#error "build with -DDDP_NV=<joint count> (kernels/_build.py)"
#endif
static_assert(DDP_NV >= 1, "a model has at least one joint");

template <typename S, int NV>
int launch(const void* topo_, const void* consts_, const void* qvu_, void* a_, void* Aq_,
           void* Av_, void* Mi_, void* Lf_, void* H_, int N, cudaStream_t stream) {
  const auto topo = static_cast<const int*>(topo_);
  const auto consts = static_cast<const S*>(consts_);
  const auto qvu = static_cast<const S*>(qvu_);
  const auto a = static_cast<S*>(a_);
  const auto Mi = static_cast<S*>(Mi_);
  const auto Lf = static_cast<S*>(Lf_);
  const auto Aq = static_cast<S*>(Aq_);
  const auto Av = static_cast<S*>(Av_);
  const auto H = static_cast<S*>(H_);
  const int blocks = (N + 63) / 64;
  fd2_primal_kernel<S, NV><<<blocks, 64, 0, stream>>>(topo, consts, qvu, a, Mi, Lf, H, N);
  fd2_pair_kernel<S, NV, QQ><<<dim3(blocks, pair_count<QQ, NV>()), 64, 0, stream>>>(
      topo, consts, qvu, a, Mi, Lf, Aq, Av, H, N);
  fd2_pair_kernel<S, NV, QV><<<dim3(blocks, pair_count<QV, NV>()), 64, 0, stream>>>(
      topo, consts, qvu, a, Mi, Lf, Aq, Av, H, N);
  fd2_pair_kernel<S, NV, VV><<<dim3(blocks, pair_count<VV, NV>()), 64, 0, stream>>>(
      topo, consts, qvu, a, Mi, Lf, Aq, Av, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``topo``, ``consts`` and
// ``qvu`` are ddp_fd_derivs's (fd_derivs.cu); ``Lf`` is a scratch buffer of
// [nv*(nv+1)/2, N] for the factor of M; ``H`` is [nv*(3nv)*(3nv), N].
// Returns cudaGetLastError() after the four launches; -1 for an nv other
// than the one this library was built for.
extern "C" int ddp_fd_derivs2(int is_double, int nv, int N, const void* topo,
                              const void* consts, const void* qvu, void* a,
                              void* Aq, void* Av, void* Mi, void* Lf, void* H,
                              void* stream) {
  if (nv != DDP_NV) return -1;  // a wrong library: the wrapper loads one per joint count
  if (N <= 0) return 0;  // an empty grid is not a valid launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double, DDP_NV>(topo, consts, qvu, a, Aq, Av, Mi, Lf, H, N, s)
                   : launch<float, DDP_NV>(topo, consts, qvu, a, Aq, Av, Mi, Lf, H, N, s);
}
