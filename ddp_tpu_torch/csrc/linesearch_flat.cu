// Fused line search of the batched AL-DDP solver for flat-lane problems, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ddp_tpu/kernels/linesearch_flat.py
// (_ls_kernel, launched by linesearch_pallas's pl.pallas_call) on the
// forward="kernel" path of ddp_tpu_torch.solver.batched.solve_batched;
// wrapper and plain version: ddp_tpu_torch/kernels/linesearch_flat.py.
//
// One launch does the whole line search of one solver iteration.  For every
// lane, candidate c < C rolls the closed loop
//     u_t = us_t + step_c k_t + K_t (x_t - xs_t),   x_{t+1} = f(x_t, u_t)
// out at step_c = 2^-c and sums the augmented-Lagrangian cost
//     l(x_t, u_t) + p_t(x_t) eq_t + (mu/2) |eq_t|^2,   p_t = pe_t + pex_t (x_t - xs_t)
// plus the terminal cost; one more row rolls out at step 0, which follows the
// stored trajectory, and its cost is the incumbent's.  The lane takes the
// largest step whose cost did not rise against that row and gets that
// candidate's trajectory; a lane where every candidate raised the cost gets
// its inputs back, bit for bit, and step 0.  The dynamics, the cost and the
// constraint are the device functions of the problem class
// (flat_problem.cuh).
//
// What bounds it on this card: not bytes (at the headline, T = 32, B = 4096,
// C = 4, float: inputs and outputs of 6.4 MB, 1.9 us at 3.35 TB/s) and not the
// arithmetic rate ((C + 1) x T steps of some forty operations a lane), but a
// lane's dependent chain of step evaluations and the latency of each link:
// rolling the chosen candidate out again to write it doubles the chain, and
// an operand read from global memory inside it costs a load latency a link.
//
// What the design does about it:
//   - a lane per group of G threads, G the power of two at least C + 1, LPB
//     lanes a block (32 where the shared memory allows, fewer for many
//     candidates, long horizons or double): thread r * LPB + l is role r of
//     lane l, so with 32 lanes a block every warp holds one role of 32 lanes
//     and the roles run side by side without diverging.  Roles 0 .. C-1 roll
//     out the candidates, role C the step-0 row; the roles left over help to
//     stage and to write.  G and LPB are the launch plan's (linesearch_plan
//     below), chosen from C, T and the type;
//   - the inputs read batch-major as they stand: a block's LPB consecutive
//     lanes are one contiguous span of each array, staged once into shared
//     memory by every thread of the block with cp.async, element i of lane l
//     at l * stride + i with an odd stride, so the coalesced staging and a
//     warp's reads of one element across its lanes are both free of bank
//     conflicts; the [T, E] mask is staged once a block.  No global load is
//     left inside the time loop, and each step's operands are read one step
//     ahead;
//   - each candidate keeps its rollout (x, u) in shared memory while it sums
//     its cost, so the chosen one is copied out, not rolled out again: a
//     lane's chain is T step evaluations;
//   - the write-out of (xs, us) is spread over the block's threads and
//     coalesced batch-major: element i of lane l from the chosen candidate's
//     rollout, or from the staged inputs where no step was accepted.
//
// Order of the cost sum (it decides ties in the acceptance test, so the plain
// version in kernels/linesearch_flat.py keeps the same one): per step
//     c_t = l;  for each row a:  c_t = (c_t + p_a ce_a) + ((0.5 mu) ce_a) ce_a
// then  cost = cost + c_t  for t = 0 .. T-1 in turn, then  cost + lf(x_T).
// The acceptance scan takes the first accepted row, the largest step.
//
// T, C and B are run-time arguments (C from 1 to 31); only (NX, M, E), the
// scalar type and the problem class are compiled in.  Build without
// --use_fast_math and without -ftz: sinf/sin in their IEEE forms.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "flat_problem.cuh"

namespace {

constexpr int kMaxCandidates = 31;
constexpr int kMaxThreads = 256;   // a block, the kernel's launch bound
constexpr long kMaxSmem = 232448;  // dynamic shared memory a block may opt in to (sm_90)

template <typename S>
struct LsArgs {
  const S* xs;    // [B, T+1, NX]
  const S* us;    // [B, T, M]
  const S* k;     // [B, T, M]
  const S* K;     // [B, T, M, NX]
  const S* pe;    // [B, T, E]
  const S* pex;   // [B, T, E, NX]
  const S* mask;  // [T, E]
  const S* mu;    // [B]
  S* xs_out;      // [B, T+1, NX]
  S* us_out;      // [B, T, M]
  S* step_out;    // [B]
  int T, B, n_cand;
  int LPB;  // lanes a block, the launch plan's
};

// Offsets of one lane's arrays in its row of shared memory, in scalars: the
// staged inputs, the candidates' rollouts, the C + 1 costs and the chosen
// candidate (-1: none); `stride` is the row's length, made odd.
struct LaneLayout {
  int xs, us, k, K, pe, pex, xc, uc, cost, pick, stride;
  __host__ __device__ LaneLayout(int T, int nx, int m, int e, int n_cand) {
    int o = 0;
    xs = o, o += (T + 1) * nx;
    us = o, o += T * m;
    k = o, o += T * m;
    K = o, o += T * m * nx;
    pe = o, o += T * e;
    pex = o, o += T * e * nx;
    xc = o, o += n_cand * (T + 1) * nx;
    uc = o, o += n_cand * T * m;
    cost = o, o += n_cand + 1;
    pick = o, o += 1;
    stride = o | 1;
  }
};

// The launch plan of (T, nx, m, e, n_cand) in a type of `item` bytes: G
// threads a lane (the power of two at least n_cand + 1), LPB lanes a block
// (at most 32, G * LPB at most kMaxThreads, the largest power of two whose
// rows and the block's mask fit the shared memory) and the block's
// shared-memory bytes.  Returns false when not even one lane fits.
inline bool linesearch_plan(int T, int nx, int m, int e, int n_cand, int item, int* G,
                            int* LPB, long* smem) {
  int g = 2;
  while (g < n_cand + 1) g *= 2;
  const long lane = static_cast<long>(LaneLayout(T, nx, m, e, n_cand).stride) * item;
  const long mask = static_cast<long>(T) * e * item;
  for (int lpb = kMaxThreads / g < 32 ? kMaxThreads / g : 32; lpb >= 1; lpb /= 2) {
    if (lane * lpb + mask <= kMaxSmem) {
      *G = g;
      *LPB = lpb;
      *smem = lane * lpb + mask;
      return true;
    }
  }
  return false;
}

// Stage a block's span of one batch-major input of n elements a lane:
// element i of lane l into the lanes' rows at l * stride + off + i, by every
// thread of the block, coalesced.  Each thread walks (l, i) along with its
// index instead of dividing by n at every element.
template <typename S>
__device__ __forceinline__ void stage_span(S* rows, int stride, int off, const S* span, int n,
                                           int lanes, int tid, int nthreads) {
  int l = tid / n, i = tid - l * n;
  const int dl = nthreads / n, di = nthreads - dl * n;
  for (int idx = tid; idx < lanes * n; idx += nthreads) {
    __pipeline_memcpy_async(rows + l * stride + off + i, span + idx, sizeof(S));
    l += dl;
    i += di;
    if (i >= n) i -= n, ++l;
  }
}

// Write a block's span of one batch-major output of n elements a lane, by
// every thread of the block, coalesced: element i of lane l from the chosen
// candidate's rollout (kept at `kept`, n a candidate) or, where the lane
// chose none, from its staged input at `staged`.
template <typename S>
__device__ __forceinline__ void write_span(S* span, const S* rows, int stride, int pick, int n,
                                           int staged, int kept, int lanes, int tid, int nthreads) {
  int l = tid / n, i = tid - l * n;
  const int dl = nthreads / n, di = nthreads - dl * n;
  for (int idx = tid; idx < lanes * n; idx += nthreads) {
    const S* r = rows + l * stride;
    const int c = static_cast<int>(r[pick]);
    span[idx] = c < 0 ? r[staged + i] : r[kept + c * n + i];
    l += dl;
    i += di;
    if (i >= n) i -= n, ++l;
  }
}

// Step t's operands of one lane, read from its row: the stored state and
// control, the gains, the multipliers and the mask.
template <typename S, int NX, int M, int E>
struct StepOperands {
  static constexpr int EK = E > 0 ? E : 1;
  S xs[NX], us[M], k[M], K[M][NX], pe[EK], pex[EK][NX], mask[EK];
  __device__ __forceinline__ void load(const S* row, const LaneLayout& lay, const S* mask_te,
                                       int t) {
    for (int j = 0; j < NX; ++j) xs[j] = row[lay.xs + t * NX + j];
    for (int i = 0; i < M; ++i) {
      us[i] = row[lay.us + t * M + i];
      k[i] = row[lay.k + t * M + i];
      for (int j = 0; j < NX; ++j) K[i][j] = row[lay.K + (t * M + i) * NX + j];
    }
    for (int r = 0; r < E; ++r) {
      pe[r] = row[lay.pe + t * E + r];
      for (int j = 0; j < NX; ++j) pex[r][j] = row[lay.pex + (t * E + r) * NX + j];
      mask[r] = mask_te[t * E + r];
    }
  }
};

template <typename S, typename P, int E>
__global__ void __launch_bounds__(kMaxThreads) linesearch_flat_kernel(
    const LsArgs<S> a, const S* __restrict__ consts, int advance) {
  static_assert(E == 0 || E == P::NE, "constraint rows of the problem class");
  constexpr int NX = P::NX, M = P::M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const sm = reinterpret_cast<S*>(smem_raw);
  const int T = a.T, C = a.n_cand, LPB = a.LPB;
  const int tid = static_cast<int>(threadIdx.x), nthreads = static_cast<int>(blockDim.x);
  const int slot = tid % LPB, role = tid / LPB;
  const int b0 = static_cast<int>(blockIdx.x) * LPB;
  const int lanes = a.B - b0 < LPB ? a.B - b0 : LPB;  // this block's lanes in the batch
  const LaneLayout lay(T, NX, M, E, C);
  S* const mask = sm + static_cast<size_t>(LPB) * lay.stride;  // [T, E], once a block

  // ---------------- stage the block's span of every input --------------------
  const size_t b0s = static_cast<size_t>(b0);
  const int ns = lay.stride;
  stage_span(sm, ns, lay.xs, a.xs + b0s * (T + 1) * NX, (T + 1) * NX, lanes, tid, nthreads);
  stage_span(sm, ns, lay.us, a.us + b0s * T * M, T * M, lanes, tid, nthreads);
  stage_span(sm, ns, lay.k, a.k + b0s * T * M, T * M, lanes, tid, nthreads);
  stage_span(sm, ns, lay.K, a.K + b0s * T * M * NX, T * M * NX, lanes, tid, nthreads);
  if constexpr (E > 0) {
    stage_span(sm, ns, lay.pe, a.pe + b0s * T * E, T * E, lanes, tid, nthreads);
    stage_span(sm, ns, lay.pex, a.pex + b0s * T * E * NX, T * E * NX, lanes, tid, nthreads);
    for (int i = tid; i < T * E; i += nthreads)
      __pipeline_memcpy_async(mask + i, a.mask + i, sizeof(S));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---------------- the C candidates and the step-0 row, a role each ---------
  S* const row = sm + slot * lay.stride;
  if (slot < lanes && role <= C) {
    const P prob(consts, advance);
    const bool keep = role < C;  // the step-0 row keeps nothing
    // the step ladder 1, 1/2, ..., 2^-(C-1); row C carries step 0
    const S step = keep ? S(1) / S(1u << role) : S(0);
    const S mu = a.mu[b0 + slot];
    S* const xc = row + lay.xc + role * (T + 1) * NX;
    S* const uc = row + lay.uc + role * T * M;
    StepOperands<S, NX, M, E> op;
    S x[NX];
    for (int i = 0; i < NX; ++i) {
      x[i] = row[lay.xs + i];
      if (keep) xc[i] = x[i];
    }
    op.load(row, lay, mask, 0);
    S cost = S(0);
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      S dx[NX], u[M];
      for (int j = 0; j < NX; ++j) dx[j] = x[j] - op.xs[j];
      for (int i = 0; i < M; ++i) {
        S s = op.us[i] + step * op.k[i];
        for (int j = 0; j < NX; ++j) s = s + op.K[i][j] * dx[j];
        u[i] = s;
        if (keep) uc[t * M + i] = s;
      }
      S ct = prob.stage(x, u);
      if constexpr (E > 0) {
        bool any = false;
        for (int r = 0; r < E; ++r) any = any || op.mask[r] != S(0);
        if (any) {
          S ce[E];
          prob.eq(x, u, ce);
          for (int r = 0; r < E; ++r) {
            const S cea = ce[r] * op.mask[r];
            S p = op.pe[r];
            for (int j = 0; j < NX; ++j) p = p + op.pex[r][j] * dx[j];
            ct = ct + p * cea + S(0.5) * mu * cea * cea;
          }
        }
      }
      cost = cost + ct;
      if (t + 1 < T) op.load(row, lay, mask, t + 1);  // the next step's, ahead
      S xn[NX];
      prob.dynamics(x, u, xn);
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        if (keep) xc[(t + 1) * NX + i] = xn[i];
      }
    }
    row[lay.cost + role] = cost + prob.terminal(x);
  }
  __syncthreads();

  // ---------------- acceptance: the first accepted row is the largest step ---
  if (slot < lanes && role == 0) {
    const S cost0 = row[lay.cost + C];
    int chosen = -1;
    for (int r = C - 1; r >= 0; --r)
      if (row[lay.cost + r] - cost0 <= S(0)) chosen = r;
    row[lay.pick] = S(chosen);
    a.step_out[b0 + slot] = chosen >= 0 ? S(1) / S(1u << chosen) : S(0);
  }
  __syncthreads();

  // ---------------- write-out, every thread, coalesced batch-major -----------
  write_span(a.xs_out + b0s * (T + 1) * NX, sm, ns, lay.pick, (T + 1) * NX, lay.xs, lay.xc, lanes,
             tid, nthreads);
  write_span(a.us_out + b0s * T * M, sm, ns, lay.pick, T * M, lay.us, lay.uc, lanes, tid, nthreads);
}

// ------------------------------------------------------------ launch

template <typename S, typename P, int E>
int launch(const void* const* p, const void* consts, int advance, int T, int B, int n_cand,
           int* plan, cudaStream_t stream) {
  LsArgs<S> a;
  a.xs = static_cast<const S*>(p[0]);
  a.us = static_cast<const S*>(p[1]);
  a.k = static_cast<const S*>(p[2]);
  a.K = static_cast<const S*>(p[3]);
  a.pe = static_cast<const S*>(p[4]);
  a.pex = static_cast<const S*>(p[5]);
  a.mask = static_cast<const S*>(p[6]);
  a.mu = static_cast<const S*>(p[7]);
  a.xs_out = static_cast<S*>(const_cast<void*>(p[8]));
  a.us_out = static_cast<S*>(const_cast<void*>(p[9]));
  a.step_out = static_cast<S*>(const_cast<void*>(p[10]));
  a.T = T;
  a.B = B;
  a.n_cand = n_cand;
  int G;
  long smem;
  if (!linesearch_plan(T, P::NX, P::M, E, n_cand, sizeof(S), &G, &a.LPB, &smem)) return -1;
  if (plan != nullptr) {
    plan[0] = G;
    plan[1] = a.LPB;
    plan[2] = static_cast<int>(smem);
  }
  auto kernel = linesearch_flat_kernel<S, P, E>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + a.LPB - 1) / a.LPB;
  kernel<<<blocks, G * a.LPB, smem, stream>>>(a, static_cast<const S*>(consts), advance);
  return static_cast<int>(cudaGetLastError());
}

// dims: class id, nx, m, e
template <typename S>
int launch_class(const int* dims, const void* const* p, const void* consts, int advance, int T,
                 int B, int n_cand, int* plan, cudaStream_t s) {
  const int e = dims[3];
  if (dims[0] == 0 && dims[1] == 2 && dims[2] == 1) {
    using P = PendulumEulerTarget<S>;
    if (e == 1) return launch<S, P, 1>(p, consts, advance, T, B, n_cand, plan, s);
    if (e == 0) return launch<S, P, 0>(p, consts, advance, T, B, n_cand, plan, s);
  }
  return -1;
}

}  // namespace

// Plain C entry point, loaded through ctypes.  ``ptrs`` points at 11 device
// pointers in the order xs, us, k, K, pe, pex, mask, mu, xs_out, us_out,
// step_out, all batch-major and contiguous (pe, pex, mask are not read when
// e == 0); ``consts`` is the problem class's constant buffer.  ``plan`` (host,
// may be null) receives the launch plan: G threads a lane, LPB lanes a block,
// shared-memory bytes a block.  Returns cudaGetLastError() after the launch;
// -1 for a class, dims, a horizon or a candidate count this build does not
// take, or a lane too large for the shared memory.
extern "C" int ddp_linesearch_flat(int is_double, int class_id, int nx, int m, int e, int T,
                                   int B, int n_cand, int advance, const void* const* ptrs,
                                   const void* consts, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cand < 1 || n_cand > kMaxCandidates || T < 1) return -1;
  if (B <= 0) return 0;  // an empty grid is not a valid launch
  const int dims[] = {class_id, nx, m, e};
  return is_double ? launch_class<double>(dims, ptrs, consts, advance, T, B, n_cand, plan, s)
                   : launch_class<float>(dims, ptrs, consts, advance, T, B, n_cand, plan, s);
}
