// Batched forward-dynamics derivative blocks for tree robots with revolute
// and prismatic joints, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/fd_derivs.py
// (_fd_kernel over _chain_M_bias, launched by fd_derivs_pallas's
// pl.pallas_call) on the deriv="kernel" path of
// ddp_tpu_torch.solver.batched.solve_batched.  Per sample (q, v, tau):
//
//     a       = M^-1 (tau - bias)            bias = RNEA(q, v, 0)
//     da/dq_c = -M^-1 d_(q_c) RNEA(q, v, a)   (= d bias + (d M) a, a held)
//     da/dv_c = -M^-1 d_(v_c) bias           (M does not depend on v)
//     da/dtau = M^-1
//
// the implicit-function scheme of the TPU kernel, with (d_q M) a folded into
// one RNEA at the primal acceleration.  The chain is fd_chain.cuh's (shared
// with fd_derivs2.cu): world kinematics, world spatial inertias, RNEA with
// gravity and damping, composite bodies for M, one Cholesky of M (IEEE sqrt).
//
// The model is DATA, not code: one library serves every model with NV joints.
// ``topo`` holds joint types (0 revolute, 1 prismatic) and parents (a parent
// precedes its children; -1 for a root), ``consts`` the axes, placements,
// spatial inertias, gravity and damping; all threads read the same addresses,
// which the cache broadcasts.
//
// What bounds it on this card: the function is some 10^5 flops a sample
// against 4*(4*NV + 3*NV^2) bytes, so operations, and in practice the
// latency of the chain's per-body arrays: the tree is walked with run-time
// parent indices, so they live in local memory.  The first design ran the
// whole chain in dual numbers in each of 2*NV + 1 threads a sample, so every
// thread repeated the primal chain and the factorization, and the v threads
// carried tangents that are exact zeros through the kinematics and M.
//
// What the design does about it: three launches, each thread carrying only
// what depends on its direction, sample last in every array:
//
//   1. the primal pass, a thread per sample: the chain once in plain numbers,
//      one factorization; writes a, M^-1, the factor (packed lower triangle)
//      and the kinematics (world subspace columns and inertias) to scratch
//      buffers of the wrapper's;
//   2. the q pass, a thread per sample and q direction: RNEA(q, v, a) in Dual
//      numbers with the kinematics, each body's world inertia a temporary of
//      the pass down the tree (chain_rnea): no composite inertias, no M, no
//      factorization; the column is solved against the stored factor;
//   3. the v pass, a thread per sample and v direction: the RNEA half alone in
//      Dual numbers over the primal pass's kinematics, read from the scratch
//      buffer (faster on an H100 than computing them again in plain numbers:
//      PERF.md section 6).  The joint accelerations carry no v tangent, so the
//      bias at zero acceleration has the same tangent bit for bit.
//
// A block is 64 samples of one direction, so its threads never diverge.  Any
// N; the ragged edge is masked.  Layout: input [3*NV, N] (q rows, v rows, tau
// rows), outputs [NV, N] and three [NV*NV, N] with matrices flattened
// row-major; scratch: the factor [NV*(NV+1)/2, N] and the kinematics
// [42*NV, N] (row 42*i + a: Sw[i][a] for a < 6, Iw[i][a - 6] after).
//
// Build without --use_fast_math and without -ftz: a non-positive pivot must
// give NaN through sqrt, as in the plain version.

#include <cuda_runtime.h>

#include <cstddef>

#include "fd_chain.cuh"

namespace {

// rows of the kinematics scratch per body: 6 subspace entries, 36 inertia
constexpr int KIN_ROWS = 42;

template <typename S, int NV>
__device__ __forceinline__ void load_factor(const S* __restrict__ Lf, size_t Ns, int n,
                                            S (*L)[NV]) {
  for (int r = 0; r < NV; ++r)
    for (int c = 0; c <= r; ++c) L[r][c] = Lf[(r * (r + 1) / 2 + c) * Ns + n];
}

// the primal pass: a, M^-1, the factor of M and the kinematics
template <typename S, int NV>
__global__ void __launch_bounds__(64) fd_primal_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts, const S* __restrict__ qvu,
    S* __restrict__ a_out, S* __restrict__ Mi, S* __restrict__ Lf, S* __restrict__ kin, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  S q[NV], v[NV], Sw[NV][6], IC[NV][36], M[NV][NV], bias[NV], L[NV][NV], a[NV];
  for (int k = 0; k < NV; ++k) {
    q[k] = qvu[k * Ns + n];
    v[k] = qvu[(NV + k) * Ns + n];
  }
  chain_kinematics<S, S, NV>(md, q, Sw, IC);
  for (int i = 0; i < NV; ++i) {
    for (int c = 0; c < 6; ++c) kin[(i * KIN_ROWS + c) * Ns + n] = Sw[i][c];
    for (int c = 0; c < 36; ++c) kin[(i * KIN_ROWS + 6 + c) * Ns + n] = IC[i][c];
  }
  chain_bias<S, S, NV>(
      md, v, [&](int i, int c) { return Sw[i][c]; }, [&](int i, int c) { return IC[i][c]; }, bias);
  chain_mass<S, S, NV>(md, Sw, IC, M);
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
}

// the q pass: column c = blockIdx.y of da/dq = -M^-1 d_(q_c) RNEA(q, v, a)
template <typename S, int NV>
__global__ void __launch_bounds__(64) fd_q_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts, const S* __restrict__ qvu,
    const S* __restrict__ a_in, const S* __restrict__ Lf, S* __restrict__ Aq, int N) {
  using D = Dual<S>;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int c = blockIdx.y;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  S a[NV], L[NV][NV], col[NV];
  D qd[NV], vd[NV], tau[NV];
  for (int k = 0; k < NV; ++k) {
    qd[k] = D(qvu[k * Ns + n], k == c ? S(1) : S(0));
    vd[k] = D(qvu[(NV + k) * Ns + n]);
    a[k] = a_in[k * Ns + n];
  }
  chain_rnea<D, S, NV>(md, qd, vd, a, tau);
  load_factor<S, NV>(Lf, Ns, n, L);
  for (int r = 0; r < NV; ++r) col[r] = -tau[r].t;
  chol_apply<S, NV>(L, col);
  for (int r = 0; r < NV; ++r) Aq[(r * NV + c) * Ns + n] = col[r];
}

// the v pass: column c = blockIdx.y of da/dv = -M^-1 d_(v_c) bias
template <typename S, int NV>
__global__ void __launch_bounds__(64) fd_v_kernel(
    const int* __restrict__ topo, const S* __restrict__ consts, const S* __restrict__ qvu,
    const S* __restrict__ kin, const S* __restrict__ Lf, S* __restrict__ Av, int N) {
  using D = Dual<S>;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int c = blockIdx.y;
  const size_t Ns = static_cast<size_t>(N);
  const ModelView<S, NV> md(topo, consts);
  S L[NV][NV], col[NV];
  D vd[NV], bias[NV];
  for (int k = 0; k < NV; ++k) vd[k] = D(qvu[(NV + k) * Ns + n], k == c ? S(1) : S(0));
  chain_bias<D, S, NV>(
      md, vd, [&](int i, int r) { return D(kin[(i * KIN_ROWS + r) * Ns + n]); },
      [&](int i, int r) { return D(kin[(i * KIN_ROWS + 6 + r) * Ns + n]); }, bias);
  load_factor<S, NV>(Lf, Ns, n, L);
  for (int r = 0; r < NV; ++r) col[r] = -bias[r].t;
  chol_apply<S, NV>(L, col);
  for (int r = 0; r < NV; ++r) Av[(r * NV + c) * Ns + n] = col[r];
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
           void* Av_, void* Mi_, void* Lf_, void* kin_, int N, cudaStream_t stream) {
  const auto topo = static_cast<const int*>(topo_);
  const auto consts = static_cast<const S*>(consts_);
  const auto qvu = static_cast<const S*>(qvu_);
  const auto a = static_cast<S*>(a_);
  const auto Lf = static_cast<S*>(Lf_);
  const auto kin = static_cast<S*>(kin_);
  const int blocks = (N + 63) / 64;
  fd_primal_kernel<S, NV><<<blocks, 64, 0, stream>>>(topo, consts, qvu, a, static_cast<S*>(Mi_),
                                                      Lf, kin, N);
  fd_q_kernel<S, NV><<<dim3(blocks, NV), 64, 0, stream>>>(topo, consts, qvu, a, Lf,
                                                          static_cast<S*>(Aq_), N);
  fd_v_kernel<S, NV><<<dim3(blocks, NV), 64, 0, stream>>>(topo, consts, qvu, kin, Lf,
                                                          static_cast<S*>(Av_), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``topo`` is int32 [2*nv]
// (joint types, parents); ``consts`` is [51*nv + 3 + nv] of the working type
// (axes, jp_rot, jp_trans, inertias, gravity, damping); ``qvu`` is
// [3*nv, N]; ``Lf`` [nv*(nv+1)/2, N] and ``kin`` [42*nv, N] are scratch.
// Returns cudaGetLastError() after the three launches; -1 for an nv other
// than the one this library was built for.
extern "C" int ddp_fd_derivs(int is_double, int nv, int N, const void* topo,
                             const void* consts, const void* qvu, void* a,
                             void* Aq, void* Av, void* Mi, void* Lf, void* kin, void* stream) {
  if (nv != DDP_NV) return -1;  // a wrong library: the wrapper loads one per joint count
  if (N <= 0) return 0;  // an empty grid is not a valid launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double, DDP_NV>(topo, consts, qvu, a, Aq, Av, Mi, Lf, kin, N, s)
                   : launch<float, DDP_NV>(topo, consts, qvu, a, Aq, Av, Mi, Lf, kin, N, s);
}
