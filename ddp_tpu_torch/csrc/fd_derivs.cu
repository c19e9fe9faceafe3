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
// The chain (fd_chain.cuh, shared with fd_derivs2.cu): world kinematics
// (Rodrigues rotation per revolute joint, fixed placement, parent chain),
// world spatial inertias X^T I X, composite bodies for M, RNEA with gravity
// and damping for the bias, one Cholesky of M (IEEE sqrt), then
// forward/backward substitutions against that factor.
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

#include <cstddef>

#include "fd_chain.cuh"

namespace {

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
