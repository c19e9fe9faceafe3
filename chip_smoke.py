#!/usr/bin/env python3
"""Run ddp_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
2. build: compiles csrc/riccati_small.cu, csrc/fd_derivs.cu,
   csrc/fd_derivs2.cu, csrc/linesearch_flat.cu and csrc/flat_solve.cu with
   nvcc (sm_90a), each loaded from a thread of its own so all five compile at
   once.
3. kernels vs their plain versions on the card, numpy-seeded inputs.
   Riccati: (n, m, e) = (2, 1, 1) at B=4096, T=32 in f32 and f64, (12, 6, 6)
   at B=512, T=16 in f64, (14, 7, 3) at B=256, T=16 in f64 and f32, a ragged
   B=1000, and one lane forced non-PD; with the second-order terms (non-zero
   rank-3 slabs) (2, 1, 1) at B=4096, T=32, (4, 2, 2) at a ragged B=1000,
   (14, 7, 3) at B=256, T=16 in f64 and f32, and one lane forced non-PD.
   fd-derivatives, first and second order: panda7 at N=4096 in f32 and f64,
   cartpole at N=4096 in f64, a ragged N=1000; each output array is held to
   a bar relative to its largest entry, and the f32 kernel, row by row, to a
   multiple of the f32 plain version's distance from the f64 kernel; the
   second-order kernel's H must be exactly symmetric with exactly zero ττ
   and vτ blocks.
   Fused line search (kernel and plain version on a numpy-seeded state whose
   lanes accept different steps, B=4096, T=32): f64 constrained with 4 and 7
   candidates (xs, us within 1e-10 of the array's largest entry, every step
   equal), f32 constrained (2e-5; at least 99% of lanes on the same step),
   unconstrained (e = 0), a ragged B=1000, and anti-descent gains (step 0
   everywhere, the trajectory back bit for bit).  Whole solve on the headline
   problem, the plain version once per case: f64 at B=4096 (every field
   within 1e-9 of its array's largest entry, identical μ and reg), f32 (≥ 99%
   of lanes agree on us within 1e-3 of their largest |u|, feasible shares
   within 0.005), a ragged B=1000, the unconstrained twin, and one lane
   started at a NaN state, which keeps its controls while the others solve.
4. pendulum main path: bench.py's headline (4096 constrained pendulum
   swing-ups, T=32, f32, 8 AL iterations, inner_iters_max=1) through
   solve_batched with backward="kernel"; checks the kernel's launch count,
   finiteness and feasibility, then the same solve with backward="sweep"
   (lanes agree on us within 1e-3 of their largest |u|), and both again in
   f64 (1e-8, identical μ).  Then the two flat-lane paths of the same
   headline, each with every launch count set to 0 before and read after:
   path A, solve_batched(forward="kernel", backward="kernel") — 9 launches of
   the line-search kernel and 9 of the Riccati kernel, no other — and path B,
   kernels.flat_solve.solve_flat — 1 launch of the whole-solve kernel, no
   other; each is checked for finiteness, a feasible share ≥ 0.99, agreement
   with the sweep solve by the same lane-scaled bar, and in f64 1e-8 with
   identical μ.
5. arm main path: bench.py's 7-DoF fleet row (256 panda7 arms reaching an
   end-effector target, H=16, f32, 24 AL iterations) through solve_batched
   with deriv="kernel", backward="kernel", forward="seq"; checks both
   kernels' launch counts, finiteness and the feasible share, then the same
   solve with deriv="jvp", backward="sweep", and both in f64 at 6 iterations
   (us within 1e-7 of each lane's largest |u|, identical μ).
6. full second-order DDP on the arm (benchmarks/arm_second_order.py's
   recipe carried to panda7): phase 5's Gauss-Newton result warm-starts 4
   full-DDP iterations on the second_order twin of the problem
   (deriv="kernel": the second-order fd-derivatives kernel, backward="kernel":
   the Riccati kernel with its rank-3 terms, forward="seq", n_linesearch=4),
   and a cold 12-iteration full-DDP solve; checks both kernels' launch counts,
   finiteness, the chain's feasible share against the Gauss-Newton stage's,
   then the same stage through deriv="jvp", backward="sweep", and both in f64
   at 2 iterations (us within 1e-7 of each lane's largest |u|, identical μ).
7. times: each kernel vs its plain version at its main-path shape (CUDA
   events, median of 20; the second-order fd and the line search's plain
   versions median of 5; the whole solve's plain version is the one run of
   phase 3), each beside its bound, and solves/s of the main paths, paths A
   and B included (median of 3 after a warm-up).

Every phase prints one line; any failure raises and the exit code is not 0.
The last lines are a JSON object describing the kernels and the JSON result
{"ok": true, "device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import fd_derivs2 as fd2
from ddp_tpu_torch.kernels import flat_solve as fs
from ddp_tpu_torch.kernels import linesearch_flat as lsf
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.base import state_pack
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.ocp.problem import Derivs
from ddp_tpu_torch.solver import al
from ddp_tpu_torch.solver.batched import _backward_sweep, solve_batched
from ddp_tpu_torch.solver.solve import SolverParams

B, T = 4096, 32
HEADLINE = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
HEADLINE_KW = dict(n_reg_levels=1, n_linesearch=4)
SPEC = dict(
    mass=1.0, length=1.0, dt=0.01, c=1.0, target=np.array([3.14]),
    active_ts=(T,), advance_times=2, horizon=T, second_order=False,
)  # fmt: skip
# pre-loop + 8 iterations, one reg level each
EXPECTED_LAUNCHES = 1 + HEADLINE.max_iterations
DEV = "cuda"

# bench.py's 7-DoF fleet row: 256 panda7 arms, H=16, 24 AL iterations, f32
ARM_B, ARM_H = 256, 16
ARM = SolverParams(max_iterations=24, threshold=1e-5, mu=1e4, inner_iters_max=1)
ARM_KW = dict(n_linesearch=2, forward="seq", matmul_precision="highest")
ARM_REG_LEVELS = 4  # solve_batched's default ladder depth
ARM_READY = (0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785)
# fd kernel vs plain, per output array relative to its largest entry: f64
# differs by summation order only; f32 carries M⁻¹ of panda7 (wrist inertias
# of 1e-3, entries up to 4e3), where this script's first run on an H100 80GB
# HBM3 gave up to 5.5e-4.  That bar alone is loose for the small rows of the
# f32 outputs, so each row of the f32 kernel's outputs must also lie within
# FD_F32_VS_PLAIN times the plain f32 version's distance from the f64 kernel
FD_BAR = {torch.float64: 1e-9, torch.float32: 2e-3}
FD_F32_VS_PLAIN = 2.0
# (the second-order kernel is held to the same bars: H of panda7 reaches 8e3
# and its first f32 run gave 1.6e-4 of that, worst row 1.408× the plain
# version's distance from the f64 kernel)
# the full-DDP polish stage and the cold full-DDP solve of the arm
DDP = SolverParams(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)
DDP_COLD = DDP._replace(max_iterations=12)
DDP_KW = dict(n_linesearch=4, forward="seq", matmul_precision="highest")
# published peaks of one H100 SXM used for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def headline_x0s(dtype):
    """bench.py's initial states: q ~ U(-π, π) from default_rng(0), v = 0."""
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1)
    return torch.tensor(x0, dtype=dtype, device=DEV)


# ------------------------------------------------------------ kernel inputs


def pendulum_inputs(Bk, dtype, bad_lane=None):
    """Pendulum derivatives along a numpy-seeded rollout with non-trivial
    multipliers, packed [T, rows, B] (≙ tests/test_pallas_riccati.py's
    make_batch)."""
    rng = np.random.default_rng(1)
    problem = problem_from_numpy(dict(SPEC, target=np.array([2.0])), device=DEV, dtype=dtype)
    kw = dict(dtype=dtype, device=DEV)
    x0s = torch.tensor(0.4 * rng.normal(size=(Bk, 2)), **kw)
    us = torch.tensor(0.3 * rng.normal(size=(Bk, T, 1)), **kw)
    xs = problem.rollout(x0s, us)
    derivs = problem.derivatives(xs, us)
    mults = al.init_multipliers(problem, xs)
    val = torch.tensor(0.3 * rng.normal(size=mults.val.shape), **kw)
    jac = torch.tensor(0.1 * rng.normal(size=mults.jac.shape), **kw)
    if bad_lane is not None:
        luu = derivs.luu.clone()
        luu[bad_lane] = -10.0
        derivs = derivs._replace(luu=luu)
    mu = torch.full((Bk,), 1e3, **kw)
    reg = torch.zeros(Bk, **kw)
    return rs.pack_batch_last(derivs, val, jac), mu, reg


def spd_inputs(Bk, Tk, n, m, e, dtype, second_order=False, bad_lane=None):
    """Random blocks at arbitrary dims: fx near I, an SPD stage-cost Hessian,
    non-trivial constraint rows and multipliers; with ``second_order`` also
    non-zero symmetric dynamics and constraint Hessian slabs (small against
    the cost Hessian, so Quu stays PD), packed for the second-order sweep.
    ``bad_lane``: that lane's luu is made negative definite."""
    rng = np.random.default_rng(3)
    nz = n + m
    G = rng.normal(size=(Bk, Tk, nz, nz)) / np.sqrt(nz)
    lzz = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(nz)
    lfG = rng.normal(size=(Bk, n, n)) / np.sqrt(n)
    z = np.zeros
    f = dict(
        lx=rng.normal(size=(Bk, Tk, n)), lu=rng.normal(size=(Bk, Tk, m)),
        lxx=lzz[..., :n, :n], lux=lzz[..., n:, :n], luu=lzz[..., n:, n:],
        fx=np.eye(n) + 0.05 * rng.normal(size=(Bk, Tk, n, n)),
        fu=0.1 * rng.normal(size=(Bk, Tk, n, m)),
        fxx=z((Bk, Tk, n, n, n)), fux=z((Bk, Tk, n, m, n)), fuu=z((Bk, Tk, n, m, m)),
        eq=0.1 * rng.normal(size=(Bk, Tk, e)),
        eqx=0.1 * rng.normal(size=(Bk, Tk, e, n)),
        equ=0.1 * rng.normal(size=(Bk, Tk, e, m)),
        eqxx=z((Bk, Tk, e, n, n)), equx=z((Bk, Tk, e, m, n)), equu=z((Bk, Tk, e, m, m)),
        lfx=rng.normal(size=(Bk, n)),
        lfxx=lfG @ np.swapaxes(lfG, -1, -2) + 0.1 * np.eye(n),
    )  # fmt: skip
    if second_order:
        for name, rows in (("f", n), ("eq", e)):
            H = 2e-4 * rng.normal(size=(Bk, Tk, rows, nz, nz))
            H = 0.5 * (H + np.swapaxes(H, -1, -2))
            f[name + "xx"], f[name + "ux"], f[name + "uu"] = (
                H[..., :n, :n], H[..., n:, :n], H[..., n:, n:]
            )  # fmt: skip
    if bad_lane is not None:
        f["luu"] = f["luu"].copy()
        f["luu"][bad_lane] = -10.0 * np.eye(m)
    kw = dict(dtype=dtype, device=DEV)
    derivs = Derivs(**{k: torch.tensor(np.ascontiguousarray(v), **kw) for k, v in f.items()})
    pe = torch.tensor(0.3 * rng.normal(size=(Bk, Tk, e)), **kw)
    pex = torch.tensor(0.01 * rng.normal(size=(Bk, Tk, e, n)), **kw)
    mu = torch.full((Bk,), 1e3, **kw)
    reg = torch.full((Bk,), 1e-6, **kw)
    return rs.pack_batch_last(derivs, pe, pex, second_order=second_order), mu, reg


def kernel_vs_plain(name, packed, mu, reg, Tk, n, m, e, rtol, atol):
    """Run the kernel and the plain version on the same card tensors; raise
    unless k, K agree within (rtol, atol) and the ok vectors are equal.
    Returns the max abs error and the ok vector."""
    got = rs.backward_sweep(packed, mu, reg, T=Tk, n=n, m=m, e=e)
    torch.cuda.synchronize()
    ref = rs.backward_sweep_reference(packed, mu, reg, T=Tk, n=n, m=m, e=e)
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    err = 0.0
    for a, b, label in zip(got[:2], ref[:2], ("k", "K")):
        keep = ref[2]  # failed lanes are NaN in both
        a, b = a[..., keep], b[..., keep]
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {label}")
        check(
            torch.allclose(a, b, rtol=rtol, atol=atol),
            f"{name}: {label} max err {float((a - b).abs().max())}",
        )
        err = max(err, float((a - b).abs().max()))
    say("kernel", case=name, max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol,
        ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}")  # fmt: skip
    return err, got[2]


def fd_inputs(model, N, dtype, seed=5):
    """q ~ U(−π, π), v, τ ~ N(0, 1) from a numpy seed, [N, nv] on the card."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device=DEV)
    return (
        torch.tensor(rng.uniform(-np.pi, np.pi, (N, model.nv)), **kw),
        torch.tensor(rng.normal(size=(N, model.nv)), **kw),
        torch.tensor(rng.normal(size=(N, model.nv)), **kw),
    )


def fd_kernel_vs_plain(name, model, N, dtype, model64=None, second=False):
    """Run an fd-derivatives kernel (the second-order one with ``second``)
    and its plain version on the same card tensors; raise unless each of
    (a, ∂a/∂q, ∂a/∂v, M⁻¹[, H]) agrees within FD_BAR of the array's
    largest entry.  With ``model64`` (the same model in f64) the f64 kernel
    on the same inputs is the truth: for every output array and every row i
    of it (joint i's acceleration, its derivatives, its row of M⁻¹, its
    Hessian; rows differ by orders of magnitude), the kernel's largest error
    over samples and columns, relative to the row's largest entry, may be at
    most FD_F32_VS_PLAIN times the plain version's.  So
    the f32 kernel is held to what f32 conditioning explains and no more.
    The second-order kernel's H must be exactly symmetric, with exactly zero
    ττ and vτ blocks.  Returns (max abs error over the arrays, the inputs)."""
    mod, kernel, plain = (
        (fd2, fd2.fd_derivs2, fd2.fd_derivs2_reference) if second
        else (fd, fd.fd_derivs, fd.fd_derivs_reference)
    )  # fmt: skip
    bar, ratio_bar = FD_BAR, FD_F32_VS_PLAIN
    labels = ("a", "da_dq", "da_dv", "Minv", "H")[: 5 if second else 4]
    q, v, tau = inputs = fd_inputs(model, N, dtype)
    before = mod.LAUNCHES
    got = kernel(model, q, v, tau)
    torch.cuda.synchronize()
    check(mod.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel")
    ref = plain(model, q, v, tau)
    err, rel, rels = 0.0, 0.0, {}
    for g, r, label in zip(got, ref, labels):
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {label}")
        e = float((g - r).abs().max())
        rel_e = e / float(r.abs().max())
        check(rel_e <= bar[dtype], f"{name}: {label} rel err {rel_e:.3e}")
        err, rel, rels[label] = max(err, e), max(rel, rel_e), f"{rel_e:.3e}"
    extra = {}
    if second:
        H, nv = got[4], model.nv
        check(H.shape == (N, nv, 3 * nv, 3 * nv), f"{name}: H shape {tuple(H.shape)}")
        check(torch.equal(H, H.transpose(-1, -2)), f"{name}: H is not exactly symmetric")
        check(float(H[:, :, 2 * nv :, 2 * nv :].abs().max()) == 0.0, f"{name}: ττ block not zero")
        check(float(H[:, :, nv : 2 * nv, 2 * nv :].abs().max()) == 0.0, f"{name}: vτ block not zero")
        check(float(H[:, :, :nv, 2 * nv :].abs().max()) > 0.0, f"{name}: qτ block is zero")
        extra.update(H_max=f"{float(H.abs().max()):.3e}", H_rel_err=rels["H"], symmetric=True,
                     tau_tau_zero=True)  # fmt: skip
    if model64 is not None:
        truth = kernel(model64, q.double(), v.double(), tau.double())
        worst = {"kernel_vs_f64": 0.0, "plain_vs_f64": 0.0, "row_ratio": 0.0}
        for g, r, w, label in zip(got, ref, truth, labels):
            # [N, nv, ...] → [nv, N·cols]: one line per row i
            rows = [x.double().reshape(N, model.nv, -1).transpose(0, 1).flatten(1)
                    for x in (g, r, w)]  # fmt: skip
            scale = rows[2].abs().amax(dim=1)
            k_row = (rows[0] - rows[2]).abs().amax(dim=1) / scale
            p_row = (rows[1] - rows[2]).abs().amax(dim=1) / scale
            ratio = float((k_row / p_row.clamp(min=1e-300)).max())
            check(ratio <= ratio_bar,
                  f"{name}: {label} rows {(k_row / p_row).tolist()} of the plain version's error")
            worst["row_ratio"] = max(worst["row_ratio"], ratio)
            for key, o in (("kernel_vs_f64", g), ("plain_vs_f64", r)):
                worst[key] = max(worst[key], float((o - w).abs().max() / w.abs().max()))
        extra.update({k: f"{x:.3e}" for k, x in worst.items()})
        extra["row_ratio_bar"] = ratio_bar
    say("kernel", case=name, max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}",
        bar=bar[dtype], **extra)  # fmt: skip
    return err, inputs


# per-lane factors on the line-search inputs' feed-forward gains: overlong
# steps, so that lanes accept different rungs of the ladder and some none
GAIN_SCALES = (1.5, 2.5, 5.0, 7.0, 11.0, 13.0, 100.0, 1000.0)
RESULT_FIELDS = ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n")


def linesearch_inputs(Bk, dtype, constrained=True, anti_descent=False):
    """A line-search state on the card (≙ tests/test_pallas_linesearch.py's
    make_state, numpy-seeded): the pendulum with a target of 2.0 (or
    unconstrained), a rollout from random x0s and us, random multipliers
    anchored at it, μ = 1e3, the gains of a backward sweep at reg = 0 with
    lane i's k times GAIN_SCALES[i % 8]; ``anti_descent``: k = 1e3, K = 0.
    Returns (problem, (xs, us, k, K, mult_val, mult_jac, mu))."""
    rng = np.random.default_rng(7)
    spec = dict(SPEC, target=np.array([2.0]) if constrained else None)
    problem = problem_from_numpy(spec, device=DEV, dtype=dtype)
    kw = dict(dtype=dtype, device=DEV)
    x0s = torch.tensor(0.5 * rng.normal(size=(Bk, 2)), **kw)
    us = torch.tensor(0.2 * rng.normal(size=(Bk, T, 1)), **kw)
    xs = problem.rollout(x0s, us)
    mults = al.init_multipliers(problem, xs)
    val = torch.tensor(0.3 * rng.normal(size=mults.val.shape), **kw)
    jac = torch.tensor(0.1 * rng.normal(size=mults.jac.shape), **kw)
    mu = torch.full((Bk,), 1e3, **kw)
    k, K, ok = _backward_sweep(problem.derivatives(xs, us), val, jac, mu, torch.zeros(Bk, **kw))
    check(bool(ok.all()), "line-search inputs: the backward sweep failed")
    k = k * torch.tensor(np.resize(GAIN_SCALES, Bk), **kw)[:, None, None]
    if anti_descent:
        k, K = torch.full_like(k, 1e3), torch.zeros_like(K)
    return problem, (xs, us, k.contiguous(), K.contiguous(), val, jac, mu)


def linesearch_vs_plain(name, problem, state, n_cand, bar, min_same_step):
    """Run the line-search kernel and its plain version on the same card
    tensors; raise unless at least ``min_same_step`` of the lanes chose the
    same step and, on those, xs and us agree within ``bar`` of the array's
    largest entry.  Returns (max abs error, share of lanes with equal step)."""
    before = lsf.LAUNCHES
    got = lsf.linesearch(problem, *state, n_cand)
    torch.cuda.synchronize()
    check(lsf.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel")
    ref = lsf.linesearch_reference(problem, *state, n_cand)
    same = got[2] == ref[2]
    share = float(same.float().mean())
    check(share >= min_same_step, f"{name}: only {share} of lanes chose the plain version's step")
    err = 0.0
    for g, r, label in zip(got[:2], ref[:2], ("xs", "us")):
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {label}")
        e = float((g - r)[same].abs().max())
        check(e <= bar * max(1.0, float(r.abs().max())), f"{name}: {label} max err {e:.3e}")
        err = max(err, e)
    steps = sorted({float(v) for v in got[2]})
    say("kernel", case=name, max_abs_err=f"{err:.3e}", bar_rel=bar, lanes_same_step=share,
        min_same_step=min_same_step, steps=steps,
        rejected_lanes=int((got[2] == 0).sum()))  # fmt: skip
    return err, share


def linesearch_checks():
    """Kernel #4 against its plain version at B=4096, T=32.  Returns the f32
    inputs and error for the timing phase."""
    for n_cand in (4, 7):
        linesearch_vs_plain(f"linesearch_f64_B{B}_T{T}_C{n_cand}",
                            *linesearch_inputs(B, torch.float64), n_cand, 1e-10, 1.0)  # fmt: skip
    p32, s32 = linesearch_inputs(B, torch.float32)
    # float32: sinf and the fused multiply-adds of the kernel are not bit-equal
    # to the plain version's, so a lane whose two costs tie may take another
    # rung of the ladder; the lanes that chose the same step must agree
    err32, _ = linesearch_vs_plain(f"linesearch_f32_B{B}_T{T}_C4", p32, s32, 4, 2e-5, 0.99)
    linesearch_vs_plain(f"linesearch_e0_f64_B{B}_T{T}_C4",
                        *linesearch_inputs(B, torch.float64, constrained=False), 4, 1e-10, 1.0)  # fmt: skip
    linesearch_vs_plain("linesearch_ragged_f64_B1000_C4",
                        *linesearch_inputs(1000, torch.float64), 4, 1e-10, 1.0)  # fmt: skip
    for dtype in (torch.float64, torch.float32):
        problem, state = linesearch_inputs(B, dtype, anti_descent=True)
        xs_o, us_o, step = lsf.linesearch(problem, *state, 4)
        torch.cuda.synchronize()
        check(float(step.abs().max()) == 0.0, "anti-descent: a lane accepted a step")
        check(torch.equal(xs_o, state[0]) and torch.equal(us_o, state[1]),
              "anti-descent: the incumbent did not come back bit for bit")  # fmt: skip
        say("kernel", case=f"linesearch_anti_descent_{str(dtype)[6:]}_B{B}", step_max=0.0,
            incumbent_bit_exact=True)  # fmt: skip
    return p32, s32, err32


def lane_agreement(a, b):
    """Share of lanes whose controls agree within 1e-3 of the lane's largest
    |u| (at least 1), and the largest such scaled difference."""
    diff = (a.us - b.us).abs().amax(dim=(1, 2))
    scale = b.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    return float((diff <= 1e-3 * scale).float().mean()), float((diff / scale).max())


def flat_solve_vs_plain(name, dtype, Bk, constrained=True, bad_lane=None):
    """Run the whole-solve kernel and its plain version on the headline
    problem (or its unconstrained twin, from random controls) at the same
    inputs.  float64: every field within 1e-9 of its array's largest entry
    (opt_lag, a residual of terms the size of the controls, of the largest
    |u|), identical μ and reg.  float32: the share of lanes agreeing on us by
    ``lane_agreement`` ≥ 0.99 and feasible shares within 0.005.
    ``bad_lane`` starts that lane at a NaN state: it must keep its controls
    and escalate its reg while the others are held to the bars above.
    Returns (the largest abs error on us, the plain version's seconds)."""
    spec = SPEC if constrained else dict(SPEC, target=None)
    problem = problem_from_numpy(spec, device=DEV, dtype=dtype)
    x0s = headline_x0s(dtype)[:Bk].clone()
    us0 = None
    if not constrained:
        rng = np.random.default_rng(11)
        us0 = torch.tensor(0.5 * rng.normal(size=(Bk, T, 1)), dtype=dtype, device=DEV)
    lanes = torch.ones(Bk, dtype=torch.bool, device=DEV)
    if bad_lane is not None:
        x0s[bad_lane, 0] = float("nan")
        lanes[bad_lane] = False
    kw = dict(us_init=us0, n_linesearch=HEADLINE_KW["n_linesearch"])
    before = fs.LAUNCHES
    got = fs.solve_flat(problem, HEADLINE, x0s, **kw)
    torch.cuda.synchronize()
    check(fs.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel")
    t0 = time.perf_counter()
    ref = fs.solve_flat_reference(problem, HEADLINE, x0s, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    fields = [(n, getattr(got, n), getattr(ref, n)) for n in RESULT_FIELDS]
    fields += [("mults." + n, getattr(got.mults, n), getattr(ref.mults, n)) for n in ("val", "jac")]
    for label, g, r in fields:
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g[lanes]).all()), f"{name}: non-finite {label}")
    if bad_lane is not None:
        check(bool((got.us[bad_lane] == 0).all()) and float(got.reg[bad_lane]) > 0,
              f"{name}: the bad lane moved or kept its reg")  # fmt: skip
        check(torch.equal(got.reg[bad_lane], ref.reg[bad_lane]), f"{name}: the bad lane's reg")
    us_err = float((got.us - ref.us)[lanes].abs().max())
    feas = [float((r.opt_constr[lanes] < 1e-2).float().mean()) for r in (got, ref)]
    out = dict(us_max_err=f"{us_err:.3e}", feasible_kernel=feas[0], feasible_plain=feas[1],
               plain_s=f"{plain_s:.2f}")  # fmt: skip
    if dtype == torch.float64:
        u_scale = max(1.0, float(ref.us[lanes].abs().max()))
        worst = 0.0
        for label, g, r in fields:
            if g.numel() == 0:
                continue
            scale = u_scale if label == "opt_lag" else max(1.0, float(r[lanes].abs().max()))
            rel = float((g - r)[lanes].abs().max()) / scale
            check(rel <= 1e-9, f"{name}: {label} differs by {rel:.3e} of its scale")
            worst = max(worst, rel)
        check(torch.equal(got.mu[lanes], ref.mu[lanes]), f"{name}: per-lane mu differs")
        check(torch.equal(got.reg[lanes], ref.reg[lanes]), f"{name}: per-lane reg differs")
        out.update(worst_rel_err=f"{worst:.3e}", bar_rel=1e-9, mu_identical=True,
                   reg_identical=True, mu_levels=sorted({float(v) for v in got.mu[lanes]}))  # fmt: skip
    else:
        sel_got = got._replace(us=got.us[lanes])
        agree, worst = lane_agreement(sel_got, ref._replace(us=ref.us[lanes]))
        check(agree >= 0.99, f"{name}: only {agree} of lanes agree on us to 1e-3 of their scale")
        check(abs(feas[0] - feas[1]) <= 0.005, f"{name}: feasible shares {feas}")
        out.update(lanes_us_agree=agree, us_max_scaled_err=f"{worst:.3e}",
                   mu_equal=float((got.mu == ref.mu)[lanes].float().mean()))  # fmt: skip
    say("kernel", case=name, **out)
    return us_err, plain_s


def flat_solve_checks():
    """Kernel #5 against its plain version on the headline problem, the plain
    version once per case.  Returns the f32 error on us and the f32 plain
    version's seconds at B=4096."""
    flat_solve_vs_plain(f"flat_solve_f64_B{B}_T{T}", torch.float64, B)
    err32, plain_s = flat_solve_vs_plain(f"flat_solve_f32_B{B}_T{T}", torch.float32, B)
    flat_solve_vs_plain("flat_solve_ragged_f64_B1000", torch.float64, 1000)
    flat_solve_vs_plain("flat_solve_e0_f64_B1000", torch.float64, 1000, constrained=False)
    flat_solve_vs_plain("flat_solve_bad_lane3_f64_B1000", torch.float64, 1000, bad_lane=3)
    return err32, plain_s


# ---------------------------------------------------------------- arm path


def arm_problem(dtype, second_order=False):
    """bench.py's 7-DoF row: Euler panda7 (dt = 0.01), ½‖u‖², the end
    effector at the pose of q_ready ⊕ 0.04·(1 … 7) two steps past the
    horizon, Gauss-Newton or (``second_order``) full DDP; x0s = (q_ready, 0) + 0.05·N(0, 1) from
    default_rng(0), us0 = gravity compensation tiled over the horizon."""
    kw = dict(dtype=dtype, device=DEV)
    arm = robots.panda7(**kw)
    dyn = dynamics.euler(arm, 0.01)
    fid = robots.ee_frame_id(arm, "ee")
    q_ready = torch.tensor(ARM_READY, **kw)
    q_goal = arm.integrate(q_ready, torch.tensor(0.04 * np.arange(1.0, 8.0), **kw))
    con = constraints.advance_time(
        constraints.FrameTarget(arm, arm.frame_position(fid, q_goal), fid, (ARM_H,)),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, **kw), constraint=con,
        horizon=ARM_H, second_order=second_order,
    )  # fmt: skip
    rng = np.random.default_rng(0)
    x0 = state_pack(q_ready, torch.zeros(arm.nv, **kw)).cpu().numpy()
    x0s = torch.tensor(x0[None] + 0.05 * rng.standard_normal((ARM_B, problem.nx)), **kw)
    zero_v = torch.zeros(arm.nv, **kw)
    grav = arm.rnea(x0s[:, : arm.nq], zero_v, zero_v)
    us0 = grav[:, None, :].repeat(1, ARM_H, 1)
    return problem, x0s, us0


def arm_solve(problem, x0s, us0, deriv, backward, params=ARM):
    res = solve_batched(problem, params, x0s, us_init=us0, deriv=deriv,
                        backward=backward, **ARM_KW)  # fmt: skip
    torch.cuda.synchronize()
    return res


def arm_main_path():
    """Phase 5: the fleet row through both kernels, its checks, and the
    jvp/sweep and f64 comparisons.  Returns (riccati launches, fd launches,
    problem, x0s, us0, and the four results: f32 kernel, f32 jvp/sweep, f64
    kernel at 6 iterations, with its inputs)."""
    p32, x32, u32 = arm_problem(torch.float32)
    rs.LAUNCHES = fd.LAUNCHES = 0
    res_k = arm_solve(p32, x32, u32, "kernel", "kernel")
    rs_launches, fd_launches = rs.LAUNCHES, fd.LAUNCHES
    # one derivative pass before the loop, one per iteration, one for the
    # final optimality; one backward pass before the loop and one per
    # iteration, each a launch per level of the regularization ladder
    fd_expected = 1 + ARM.max_iterations + 1
    rs_expected = (1 + ARM.max_iterations) * ARM_REG_LEVELS
    check(fd_launches == fd_expected, f"fd launches {fd_launches} != {fd_expected}")
    check(rs_launches == rs_expected, f"riccati launches {rs_launches} != {rs_expected}")
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"arm: non-finite {name}")
    check(res_k.us.shape == (ARM_B, ARM_H, 7) and res_k.xs.shape == (ARM_B, ARM_H + 1, 14),
          "arm: result shapes")  # fmt: skip
    frac_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(frac_k >= 0.90, f"arm f32 frac_main {frac_k}")
    res_j = arm_solve(p32, x32, u32, "jvp", "sweep")
    frac_j = float((res_j.opt_constr < 1e-2).float().mean())
    check(abs(frac_k - frac_j) <= 0.02, f"arm feasible shares {frac_k} vs {frac_j}")
    say("arm_f32", B=ARM_B, H=ARM_H, iters=ARM.max_iterations, fd_launches=fd_launches,
        riccati_launches=rs_launches, frac_main_kernel=frac_k, frac_main_jvp_sweep=frac_j,
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}",
        mu_equal=float((res_k.mu == res_j.mu).float().mean()))  # fmt: skip

    short = ARM._replace(max_iterations=6)
    p64, x64, u64 = arm_problem(torch.float64)
    r64_k = arm_solve(p64, x64, u64, "kernel", "kernel", short)
    r64_j = arm_solve(p64, x64, u64, "jvp", "sweep", short)
    diff = (r64_k.us - r64_j.us).abs().amax(dim=(1, 2))
    scale = r64_j.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    err64 = float((diff / scale).max())
    check(err64 <= 1e-7, f"arm f64 us max scaled err {err64}")
    check(torch.equal(r64_k.mu, r64_j.mu), "arm f64 per-lane mu differs")
    say("arm_f64", iters=short.max_iterations, us_max_scaled_err=f"{err64:.3e}",
        mu_identical=True, mu_levels=sorted({float(v) for v in r64_k.mu}))  # fmt: skip
    return rs_launches, fd_launches, p32, x32, u32, res_k, res_j, (r64_k, x64, u64)


# ------------------------------------------------- arm path, full second order


def ddp_stage(problem2, x0s, r1, deriv, backward, params=DDP):
    """Full-DDP iterations on the second_order problem, warm-started on a
    previous result's (us, mults, μ, reg, w, n)."""
    res = solve_batched(
        problem2, params, x0s, us_init=r1.us, mults_init=r1.mults, mu_init=r1.mu,
        reg_init=r1.reg, w_init=r1.w, n_init=r1.n, deriv=deriv, backward=backward, **DDP_KW,
    )  # fmt: skip
    torch.cuda.synchronize()
    return res


def reset_launch_counts():
    rs.LAUNCHES = rs.LAUNCHES_SECOND_ORDER = fd.LAUNCHES = fd2.LAUNCHES = 0
    lsf.LAUNCHES = fs.LAUNCHES = 0


def launch_counts():
    return dict(riccati=rs.LAUNCHES, fd=fd.LAUNCHES, fd2=fd2.LAUNCHES,
                linesearch=lsf.LAUNCHES, flat_solve=fs.LAUNCHES)  # fmt: skip


def check_finite(res, what):
    """Everything a caller uses of a full-DDP result is finite.  ``opt_lag``
    is left out and counted instead: the recipe caps neither μ nor the
    iteration count, so after 24 + 4 iterations in f32 μ has reached 1e16 to
    1e28 and the multipliers 1e12 to 1e21 on lanes that are feasible, and the
    stationarity measure's adjoint recursion overflows on some of them (the
    same schedule, and the same overflow, in ddp_tpu).  Returns the number of
    lanes whose ``opt_lag`` is not finite."""
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"{what}: non-finite {name}")
    check(bool(torch.isfinite(res.mults.val).all()), f"{what}: non-finite multipliers")
    return int((~torch.isfinite(res.opt_lag)).sum())


def arm_second_order_path(x32, u32, gn_k, gn_j, gn64):
    """Phase 6: the Gauss-Newton results of phase 5 warm-start the full-DDP
    polish through both new kernels; a cold full-DDP solve; the jvp/sweep
    and f64 comparisons.  Returns (fd2 launches, second-order Riccati
    launches, the second_order problem, the shares and wall times)."""
    p2, _, _ = arm_problem(torch.float32, second_order=True)
    frac_gn = float((gn_k.opt_constr < 1e-2).float().mean())
    reset_launch_counts()
    t0 = time.perf_counter()
    res_k = ddp_stage(p2, x32, gn_k, "kernel", "kernel")
    wall_k = time.perf_counter() - t0
    fd2_launches, rs2_launches = fd2.LAUNCHES, rs.LAUNCHES_SECOND_ORDER
    # one derivative pass before the loop, one per iteration, one for the
    # final optimality; a backward pass before the loop and one per
    # iteration, each a launch per level of the regularization ladder
    fd2_expected = 1 + DDP.max_iterations + 1
    rs2_expected = (1 + DDP.max_iterations) * ARM_REG_LEVELS
    check(fd2_launches == fd2_expected, f"fd2 launches {fd2_launches} != {fd2_expected}")
    check(rs2_launches == rs2_expected, f"2nd-order riccati launches {rs2_launches} != {rs2_expected}")
    check(rs.LAUNCHES == rs2_expected and fd.LAUNCHES == 0,
          f"first-order kernels ran in the full-DDP stage: {rs.LAUNCHES}, {fd.LAUNCHES}")  # fmt: skip
    lag_overflow = check_finite(res_k, "arm chain")
    check(res_k.us.shape == (ARM_B, ARM_H, 7) and res_k.xs.shape == (ARM_B, ARM_H + 1, 14),
          "arm chain: result shapes")  # fmt: skip
    frac_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(frac_k >= frac_gn - 0.01 and frac_k >= 0.90, f"chain share {frac_k} vs GN stage {frac_gn}")
    t0 = time.perf_counter()
    res_j = ddp_stage(p2, x32, gn_j, "jvp", "sweep")
    wall_j = time.perf_counter() - t0
    frac_j = float((res_j.opt_constr < 1e-2).float().mean())
    check(abs(frac_k - frac_j) <= 0.02, f"chain feasible shares {frac_k} vs {frac_j}")
    say("arm_chain_f32", B=ARM_B, H=ARM_H, gn_iters=ARM.max_iterations,
        ddp_iters=DDP.max_iterations, fd2_launches=fd2_launches,
        riccati2_launches=rs2_launches, frac_gn_stage=frac_gn, frac_chain_kernel=frac_k,
        frac_chain_jvp_sweep=frac_j,
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}",
        opt_lag_overflow_lanes=lag_overflow, mu_max=f"{float(res_k.mu.max()):.1e}",
        median_opt_lag_gn=f"{float(gn_k.opt_lag.median()):.3e}",
        median_opt_lag_chain=f"{float(res_k.opt_lag.median()):.3e}",
        lanes_improved=int((res_k.opt_constr < 0.5 * gn_k.opt_constr).sum()),
        us_moved=f"{float((res_k.us - gn_k.us).abs().max()):.3e}",
        mu_equal=float((res_k.mu == res_j.mu).float().mean()),
        first_stage_s_kernel=f"{wall_k:.3f}", stage_s_jvp_sweep=f"{wall_j:.3f}")  # fmt: skip

    # cold: no warm start, so the kernels see states far from the optimum,
    # where Quu is indefinite and the regularization ladder fires
    reset_launch_counts()
    cold = solve_batched(p2, DDP_COLD, x32, us_init=u32, deriv="kernel", backward="kernel", **DDP_KW)
    torch.cuda.synchronize()
    cold_fd2, cold_rs2 = fd2.LAUNCHES, rs.LAUNCHES_SECOND_ORDER
    check(cold_fd2 == 1 + DDP_COLD.max_iterations + 1, f"cold fd2 launches {cold_fd2}")
    check(cold_rs2 == (1 + DDP_COLD.max_iterations) * ARM_REG_LEVELS,
          f"cold 2nd-order riccati launches {cold_rs2}")  # fmt: skip
    cold_overflow = check_finite(cold, "arm cold full DDP")
    frac_cold = float((cold.opt_constr < 1e-2).float().mean())
    say("arm_cold_ddp_f32", iters=DDP_COLD.max_iterations, fd2_launches=cold_fd2,
        riccati2_launches=cold_rs2, frac_feasible=frac_cold,
        p99_eq=f"{float(torch.quantile(cold.opt_constr, 0.99)):.3e}",
        lanes_with_reg=int((cold.reg > 0).sum()), opt_lag_overflow_lanes=cold_overflow,
        mu_levels=sorted({float(v) for v in cold.mu}))  # fmt: skip

    # f64: both paths from the same Gauss-Newton state
    r64, x64, _ = gn64
    p64, _, _ = arm_problem(torch.float64, second_order=True)
    short = DDP._replace(max_iterations=2)
    r64_k = ddp_stage(p64, x64, r64, "kernel", "kernel", short)
    r64_j = ddp_stage(p64, x64, r64, "jvp", "sweep", short)
    diff = (r64_k.us - r64_j.us).abs().amax(dim=(1, 2))
    scale = r64_j.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    err64 = float((diff / scale).max())
    check(err64 <= 1e-7, f"arm chain f64 us max scaled err {err64}")
    check(torch.equal(r64_k.mu, r64_j.mu), "arm chain f64 per-lane mu differs")
    say("arm_chain_f64", ddp_iters=short.max_iterations, us_max_scaled_err=f"{err64:.3e}",
        mu_identical=True, us_moved=f"{float((r64_k.us - r64.us).abs().max()):.3e}")  # fmt: skip
    return fd2_launches, rs2_launches, p2, dict(
        frac_gn=frac_gn, frac_chain=frac_k, frac_cold=frac_cold, wall_jvp_sweep=wall_j
    )


# ------------------------------------------------------------------ timing


def riccati_bound_ms(Tk, n, m, e, Bk, second_order=False):
    """Least time for one float32 sweep: every input and output element
    moved once at the card's memory rate, or its multiply-adds at the
    float32 peak."""
    item = 4
    rows_in = sum(rs._rows(n, m, e, second_order).values())
    elems = Tk * Bk * (rows_in + m + m * n) + Bk * (n + n * n + 2)
    bytes_ms = 1e3 * (elems * item + Bk) / HBM_BYTES_PER_S
    # per step: Vxx·[fx fu], [fx fu]ᵀ·(·), the e-row terms, Cholesky, solves
    macs = n * n * (n + m) + (n + m) * n * (n + m) + 2 * e * (n + m) * n
    macs += m**3 // 3 + (1 + n) * m * m + m * n * (1 + n)
    if second_order:  # Vx·f.. and tmp·eq.. over the rank-3 slabs
        macs += (n + e) * (n * n + m * n + m * m)
    ops_ms = 1e3 * 2 * macs * Tk * Bk / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# operations of one Euler step of the pendulum class with its stage cost:
# a = -(g/l) sin q + u/m (4), q' and v' (4), the cost (c/2) u² and its sum (3)
STEP_FLOPS = 11


def linesearch_bound_ms(Tk, nx, m, e, Bk, n_cand):
    """Least time for one float32 line search: every input (xs, us, k, K, the
    multipliers, mu) and output (xs, us, step) element moved once at the
    card's memory rate, or the operations of the FUNCTION — the n_cand
    candidate rollouts and the incumbent's cost, no second rollout — at the
    float32 peak."""
    item = 4
    per_lane = (Tk + 1) * nx + Tk * (2 * m + m * nx + e + e * nx) + 1
    per_lane += (Tk + 1) * nx + Tk * m + 1
    bytes_ms = 1e3 * per_lane * Bk * item / HBM_BYTES_PER_S
    step = nx + 2 * m * (1 + nx) + STEP_FLOPS  # x - xs, the feedback law, the step
    flops = Bk * (n_cand + 1) * (Tk * step + e * (2 * STEP_FLOPS + 4 * nx + 6))
    ops_ms = 1e3 * flops / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def flat_solve_chain_steps(Tk, n_iters, n_ls):
    """Length of one lane's dependent chain in the whole-solve program, in
    step evaluations: the initial rollout, then per pass the backward sweep,
    the incumbent's cost, n_ls candidate rollouts and the accepted one, per
    iteration also the adjoint sweep, and the final adjoint sweep."""
    return Tk * (1 + (n_iters + 1) * (n_ls + 3) + n_iters + 1)


def flat_solve_bound_ms(Tk, nx, m, e, Bk, n_iters, n_ls):
    """Least time for one float32 whole solve: x0, us0 and the schedule state
    read once and the result (us, xs, fb_k, fb_K, six stats, multipliers)
    written once at the card's memory rate, or the operations of the FUNCTION
    at the float32 peak: per pass and step the derivatives (3 Jacobian columns
    of the step, the cost's gradient and Hessian: ~40), the Riccati step
    (``riccati_bound_ms``'s count), n_ls + 1 closed-loop cost evaluations, and
    per iteration the two adjoints (~2·nx·(nx + m) multiply-adds each)."""
    item = 4
    per_lane = nx + Tk * m + 4
    per_lane += Tk * m + (Tk + 1) * nx + Tk * m + Tk * m * nx + 6 + Tk * e * (1 + nx)
    bytes_ms = 1e3 * per_lane * Bk * item / HBM_BYTES_PER_S
    macs = nx * nx * (nx + m) + (nx + m) * nx * (nx + m) + 2 * e * (nx + m) * nx
    macs += m**3 // 3 + (1 + nx) * m * m + m * nx * (1 + nx)
    rollout_step = nx + 2 * m * (1 + nx) + STEP_FLOPS
    per_pass = Tk * (40 + 2 * macs + (n_ls + 1) * rollout_step)
    per_iter = Tk * (40 + 2 * 2 * 2 * nx * (nx + m))
    flops = Bk * (Tk * STEP_FLOPS + (n_iters + 1) * per_pass + (n_iters + 1) * per_iter)
    ops_ms = 1e3 * flops / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def fd_flops(parents):
    """Floating-point operations the FUNCTION (q, v, τ) → (a, ∂a/∂q, ∂a/∂v,
    M⁻¹) needs per sample for a tree with these parents, whatever a kernel
    does on top (a multiply-add is 2):

    - one primal chain.  Per body: kinematics 210 (Rodrigues 18 multiply-adds,
      fixed placement 27 + 9, parent composition 27 + 9, joint subspace 15),
      the world inertia at its structured cost 180 (rotate the 3×3 inertia 54,
      rotate and shift the centre of mass 12, parallel-axis term 24), RNEA 260
      (two 6×6 products with the inertia 72, six cross products 36, the
      subspace products 13, vector sums 18), composite sums 42; then M: a
      6×6·6 product per joint and a 6-dot per (ancestor, joint) pair;
    - nv tangents of that chain for ∂/∂q at twice its cost each, and nv
      tangents of the RNEA part alone for ∂/∂v (∂M/∂v = 0: no kinematics, no
      inertia, no M);
    - one Cholesky factor nv³/3, the products (∂_q M)·a 2·nv³, and 3·nv + 1
      forward/backward substitutions of 2·nv² each."""
    nv = len(parents)
    pairs = 0
    for j in range(nv):
        i = j
        while i >= 0:
            pairs, i = pairs + 1, parents[i]
    rnea = nv * (260 + 6)
    chain = nv * (210 + 180 + 42) + rnea + 2 * (36 * nv + 6 * pairs)
    return chain + nv * 2 * chain + nv * 2 * rnea + nv**3 // 3 + 2 * nv**3 + (3 * nv + 1) * 2 * nv * nv


def fd_bound_ms(model, N):
    """Least time for one float32 call on N samples: 3·nv inputs and
    nv + 3·nv² outputs per sample moved once at the card's memory rate, or
    ``fd_flops`` at the float peak."""
    nv, item = model.nv, 4
    bytes_ms = 1e3 * N * (3 * nv + nv + 3 * nv * nv) * item / HBM_BYTES_PER_S
    ops_ms = 1e3 * fd_flops(tuple(model.parents)) * N / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def fd2_flops(parents):
    """Floating-point operations the FUNCTION (q, v, τ) → (a, ∂a/∂q, ∂a/∂v,
    M⁻¹, H) needs per sample, whatever a kernel does on top: ``fd_flops`` for
    the first-order outputs, and for H

    - the second derivatives of the chain, at four multiply-adds per
      multiply-add of the primal (the product rule's h·b + t₁·t₂' + t₂·t₁' +
      a·h'): the whole chain for each of the nv(nv+1)/2 (q, q) pairs, the
      RNEA part alone for the nv² (q, v) and nv(nv+1)/2 (v, v) pairs (M does
      not depend on v);
    - the right-hand sides: (∂ij M)·a for (q, q) pairs, (∂i M)(∂j a) for
      each q index of a pair, 2·nv² each;
    - one forward/backward substitution of 2·nv² per pair, and for the τ
      cross block nv² products and substitutions."""
    nv = len(parents)
    pairs = 0
    for j in range(nv):
        i = j
        while i >= 0:
            pairs, i = pairs + 1, parents[i]
    rnea = nv * (260 + 6)
    chain = nv * (210 + 180 + 42) + rnea + 2 * (36 * nv + 6 * pairs)
    qq, qv = nv * (nv + 1) // 2, nv * nv
    second = 4 * (qq * chain + (qv + qq) * rnea)
    rhs = 2 * nv * nv * (qq + 2 * qq + qv)
    solves = 2 * nv * nv * ((2 * qq + qv) + 2 * nv * nv)
    return fd_flops(parents) + second + rhs + solves


def fd2_bound_ms(model, N):
    """Least time for one float32 call on N samples: 3·nv inputs and
    nv + 3·nv² + nv·(3·nv)² outputs per sample moved once at the card's
    memory rate, or ``fd2_flops`` at the float peak."""
    nv, item = model.nv, 4
    bytes_ms = 1e3 * N * (3 * nv + nv + 3 * nv * nv + 9 * nv**3) * item / HBM_BYTES_PER_S
    ops_ms = 1e3 * fd2_flops(tuple(model.parents)) * N / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def event_ms(fn, reps=20):
    """Median over ``reps`` single calls of the device time between CUDA
    events around ``fn`` (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def solve(problem, x0s, backward):
    res = solve_batched(problem, HEADLINE, x0s, backward=backward, **HEADLINE_KW)
    torch.cuda.synchronize()
    return res


def main_path():
    """Phase 4: the headline solve through the kernel, its checks, and the
    sweep-backend and f64 comparisons.  Returns (launches, problem, x0s)."""
    p32 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float32)
    x32 = headline_x0s(torch.float32)
    rs.LAUNCHES = 0
    res_k = solve(p32, x32, "kernel")
    launches = rs.LAUNCHES
    check(launches == EXPECTED_LAUNCHES, f"kernel launches {launches} != {EXPECTED_LAUNCHES}")
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"non-finite {name}")
    feas_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(feas_k >= 0.99, f"f32 feasible fraction {feas_k}")
    res_s = solve(p32, x32, "sweep")
    feas_s = float((res_s.opt_constr < 1e-2).float().mean())
    # a lane agrees when max_t |Δus| <= 1e-3 · max(1, max_t |us|).  A bare
    # 1e-3 is below what f32 resolves here: |us| reaches ~180 and the step
    # under the constraint is conditioned by μ up to 1e9, so ddp_tpu's own
    # f32 Pallas and sweep backends leave ~30% of lanes more than 1e-3 apart
    # (up to ~4e-3) on the CPU
    diff = (res_k.us - res_s.us).abs().amax(dim=(1, 2))
    scale = res_s.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    agree = float((diff <= 1e-3 * scale).float().mean())
    agree_abs = float((diff <= 1e-3).float().mean())
    check(abs(feas_k - feas_s) <= 0.005, f"feasible fractions {feas_k} vs {feas_s}")
    check(agree >= 0.99, f"only {agree} of lanes agree on us to 1e-3 of their scale")
    say("main_f32", B=B, T=T, launches=launches, feasible_kernel=feas_k,
        feasible_sweep=feas_s, lanes_us_agree=agree, lanes_us_within_abs_1em3=agree_abs,
        us_max_err=f"{float(diff.max()):.3e}",
        us_max_scaled_err=f"{float((diff / scale).max()):.3e}",
        mu_equal=float((res_k.mu == res_s.mu).float().mean()),
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}")  # fmt: skip

    p64 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float64)
    x64 = headline_x0s(torch.float64)
    r64_k, r64_s = solve(p64, x64, "kernel"), solve(p64, x64, "sweep")
    err64 = float((r64_k.us - r64_s.us).abs().max())
    check(err64 <= 1e-8, f"f64 us max err {err64}")
    check(torch.equal(r64_k.mu, r64_s.mu), "f64 per-lane mu differs")
    feas64 = float((r64_k.opt_constr < 1e-2).float().mean())
    say("main_f64", us_max_err=f"{err64:.3e}", mu_identical=True, feasible_kernel=feas64,
        mu_levels=sorted({float(v) for v in r64_k.mu}))  # fmt: skip
    return launches, p32, x32, res_s, (p64, x64, r64_s)


def flat_lane_paths(p32, x32, res_s, f64):
    """Phase 4, paths A and B: the headline through the fused line-search
    kernel with the Riccati kernel (``forward="kernel"``, ``backward="kernel"``)
    and through the one-launch whole solve (``solve_flat``).  Each is held to
    its launch counts, finiteness, the feasible share, the sweep solve
    ``res_s`` (lanes agree on us within 1e-3 of their largest |u|) and, in
    f64, to the sweep solve within 1e-8 with identical μ.  Returns the launch
    counts of path A (line search, Riccati) and of path B."""
    p64, x64, r64_s = f64
    feas_s = float((res_s.opt_constr < 1e-2).float().mean())

    def run_a(problem, x0s):
        res = solve_batched(problem, HEADLINE, x0s, backward="kernel", forward="kernel",
                            **HEADLINE_KW)  # fmt: skip
        torch.cuda.synchronize()
        return res

    def run_b(problem, x0s):
        res = fs.solve_flat(problem, HEADLINE, x0s, n_linesearch=HEADLINE_KW["n_linesearch"])
        torch.cuda.synchronize()
        return res

    out = {}
    for path, run, expected in (
        ("A", run_a, dict(riccati=EXPECTED_LAUNCHES, fd=0, fd2=0,
                          linesearch=EXPECTED_LAUNCHES, flat_solve=0)),
        ("B", run_b, dict(riccati=0, fd=0, fd2=0, linesearch=0, flat_solve=1)),
    ):  # fmt: skip
        reset_launch_counts()
        res = run(p32, x32)
        counts = launch_counts()
        check(counts == expected, f"path {path}: launches {counts} != {expected}")
        for name in RESULT_FIELDS:
            check(bool(torch.isfinite(getattr(res, name)).all()), f"path {path}: non-finite {name}")
        check(bool(torch.isfinite(res.mults.val).all() and torch.isfinite(res.mults.jac).all()),
              f"path {path}: non-finite multipliers")  # fmt: skip
        check(res.us.shape == (B, T, 1) and res.xs.shape == (B, T + 1, 2), f"path {path}: shapes")
        feas = float((res.opt_constr < 1e-2).float().mean())
        check(feas >= 0.99, f"path {path}: f32 feasible fraction {feas}")
        check(abs(feas - feas_s) <= 0.005, f"path {path}: feasible fractions {feas} vs {feas_s}")
        agree, worst = lane_agreement(res, res_s)
        check(agree >= 0.99, f"path {path}: only {agree} of lanes agree with the sweep solve")
        r64 = run(p64, x64)
        err64 = float((r64.us - r64_s.us).abs().max())
        check(err64 <= 1e-8, f"path {path}: f64 us max err {err64}")
        check(torch.equal(r64.mu, r64_s.mu), f"path {path}: f64 per-lane mu differs")
        say(f"path_{path}", B=B, T=T, launches=counts, feasible=feas, feasible_sweep=feas_s,
            lanes_us_agree=agree, us_max_scaled_err=f"{worst:.3e}",
            mu_equal=float((res.mu == res_s.mu).float().mean()),
            p99_eq=f"{float(torch.quantile(res.opt_constr, 0.99)):.3e}",
            f64_us_max_err=f"{err64:.3e}", f64_mu_identical=True)  # fmt: skip
        out[path] = counts
    return out["A"]["linesearch"], out["A"]["riccati"], out["B"]["flat_solve"]


def build_kernels():
    """Phase 2: one nvcc per source, each under its own thread's load()."""
    t0 = time.perf_counter()
    modules = (rs, fd, fd2, lsf, fs)
    sources = tuple(m.SOURCE for m in modules)
    with ThreadPoolExecutor(len(modules)) as pool:
        for built in [pool.submit(m._kernel_fn) for m in modules]:
            built.result()
    say("build", sources=",".join(sources), wall_s=f"{time.perf_counter() - t0:.1f}",
        nvcc_s=[f"{_build.build_seconds(x):.1f}" for x in sources])  # fmt: skip


def kernel_checks():
    """Phase 3: every kernel against its plain version on the card.  Returns
    what the timing phase reuses: the f32 inputs at the main paths' shapes
    and each kernel's largest f32 error."""
    f32_in = pendulum_inputs(B, torch.float32)
    err32, _ = kernel_vs_plain("headline_f32_B4096_T32", *f32_in, T, 2, 1, 1, 2e-4, 2e-5)
    kernel_vs_plain("headline_f64_B4096_T32", *pendulum_inputs(B, torch.float64),
                    T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    kernel_vs_plain("ur5dims_f64_B512_T16", *spd_inputs(512, 16, 12, 6, 6, torch.float64),
                    16, 12, 6, 6, 1e-9, 1e-9)  # fmt: skip
    kernel_vs_plain("ragged_f64_B1000_T32", *pendulum_inputs(1000, torch.float64),
                    T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    _, ok = kernel_vs_plain("nonpd_lane3_f64_B1000", *pendulum_inputs(1000, torch.float64, 3),
                            T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail")
    arm_dims = (ARM_H, 14, 7, 3)
    kernel_vs_plain("armdims_f64_B256_T16", *spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float64),
                    *arm_dims, 1e-9, 1e-9)  # fmt: skip
    arm_in = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float32)
    kernel_vs_plain("armdims_f32_B256_T16", *arm_in, *arm_dims, 2e-3, 2e-4)
    panda32 = robots.panda7(device=DEV, dtype=torch.float32)
    panda64 = robots.panda7(device=DEV, dtype=torch.float64)
    N = ARM_B * ARM_H
    fd_err32, fd_in = fd_kernel_vs_plain(f"panda7_f32_N{N}", panda32, N, torch.float32, panda64)
    fd_kernel_vs_plain(f"panda7_f64_N{N}", panda64, N, torch.float64)
    fd_kernel_vs_plain(f"cartpole_f64_N{N}", robots.cartpole(device=DEV, dtype=torch.float64),
                       N, torch.float64)  # fmt: skip
    fd_kernel_vs_plain("panda7_ragged_f64_N1000", panda64, 1000, torch.float64)
    # … with the second-order terms, non-zero rank-3 slabs
    kernel_vs_plain("so_headline_f32_B4096_T32",
                    *spd_inputs(B, T, 2, 1, 1, torch.float32, second_order=True),
                    T, 2, 1, 1, 2e-4, 2e-5)  # fmt: skip
    kernel_vs_plain("so_headline_f64_B4096_T32",
                    *spd_inputs(B, T, 2, 1, 1, torch.float64, second_order=True),
                    T, 2, 1, 1, 1e-10, 1e-10)  # fmt: skip
    kernel_vs_plain("so_n4m2e2_ragged_f64_B1000_T16",
                    *spd_inputs(1000, 16, 4, 2, 2, torch.float64, second_order=True),
                    16, 4, 2, 2, 1e-9, 1e-9)  # fmt: skip
    _, ok = kernel_vs_plain("so_nonpd_lane3_f64_B1000",
                            *spd_inputs(1000, 16, 4, 2, 2, torch.float64, True, bad_lane=3),
                            16, 4, 2, 2, 1e-9, 1e-9)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail (2nd order)")
    kernel_vs_plain("so_armdims_f64_B256_T16",
                    *spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float64, second_order=True),
                    *arm_dims, 1e-9, 1e-9)  # fmt: skip
    arm2_in = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float32, second_order=True)
    rs2_err32, _ = kernel_vs_plain("so_armdims_f32_B256_T16", *arm2_in, *arm_dims, 2e-3, 2e-4)
    fd2_err32, _ = fd_kernel_vs_plain(f"fd2_panda7_f32_N{N}", panda32, N, torch.float32,
                                      panda64, second=True)  # fmt: skip
    fd_kernel_vs_plain(f"fd2_panda7_f64_N{N}", panda64, N, torch.float64, second=True)
    fd_kernel_vs_plain(f"fd2_cartpole_f64_N{N}", robots.cartpole(device=DEV, dtype=torch.float64),
                       N, torch.float64, second=True)  # fmt: skip
    fd_kernel_vs_plain("fd2_panda7_ragged_f64_N1000", panda64, 1000, torch.float64, second=True)

    # … the fused line search and the whole solve of the flat-lane class
    ls_problem, ls_state, ls_err32 = linesearch_checks()
    fs_err32, fs_plain_s = flat_solve_checks()

    return dict(f32_in=f32_in, err32=err32, arm_in=arm_in, arm2_in=arm2_in, rs2_err32=rs2_err32,
                panda32=panda32, panda64=panda64, fd_in=fd_in, fd_err32=fd_err32,
                fd2_err32=fd2_err32, ls_problem=ls_problem, ls_state=ls_state,
                ls_err32=ls_err32, fs_err32=fs_err32, fs_plain_s=fs_plain_s)  # fmt: skip


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)  # fmt: skip

    # 2. build
    build_kernels()

    # 3. kernel vs plain version
    k3 = kernel_checks()
    f32_in, err32, arm_in, arm2_in = k3["f32_in"], k3["err32"], k3["arm_in"], k3["arm2_in"]
    panda32, panda64, fd_in = k3["panda32"], k3["panda64"], k3["fd_in"]
    fd_err32, fd2_err32, rs2_err32 = k3["fd_err32"], k3["fd2_err32"], k3["rs2_err32"]
    N = ARM_B * ARM_H

    # 4. pendulum main path
    launches, p32, x32, res_s, f64 = main_path()
    ls_launches, ls_rs_launches, fs_launches = flat_lane_paths(p32, x32, res_s, f64)
    del res_s, f64

    # 5. arm main path
    arm_rs_launches, arm_fd_launches, a32, ax32, au32, gn_k, gn_j, gn64 = arm_main_path()

    # 6. arm, full second-order DDP
    fd2_launches, rs2_launches, a2_32, chain = arm_second_order_path(ax32, au32, gn_k, gn_j, gn64)
    del gn64

    # 7. times
    packed, mu, reg = f32_in
    ms = event_ms(lambda: rs.backward_sweep(packed, mu, reg, T=T, n=2, m=1, e=1))
    plain_ms = event_ms(
        lambda: rs.backward_sweep_reference(packed, mu, reg, T=T, n=2, m=1, e=1)
    )
    bound, bound_by = riccati_bound_ms(T, 2, 1, 1, B)
    say("time_backward", card=f"'{card}'", shape=f"n2m1e1_T{T}_B{B}_f32",
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
        bound_by=bound_by)  # fmt: skip
    solve(p32, x32, "kernel")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(p32, x32, "kernel")
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    say("time_solve", card=f"'{card}'", backward="kernel", B=B,
        solve_s=[f"{w:.4f}" for w in walls], solves_per_s=f"{B / wall:.1f}",
        peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    # the fused line search: the kernel on packed arrays, the wrapper's whole
    # call (its transposing copies included), the plain version
    ls_problem, ls_state = k3["ls_problem"], k3["ls_state"]
    n_ls = HEADLINE_KW["n_linesearch"]
    ls_flat, ls_packed = lsf.pack_batch_last(ls_problem, *ls_state)
    ls_ms = event_ms(lambda: lsf.linesearch_packed(ls_flat, ls_packed, n_ls))
    ls_call_ms = event_ms(lambda: lsf.linesearch(ls_problem, *ls_state, n_ls))
    ls_plain_ms = event_ms(lambda: lsf.linesearch_reference(ls_problem, *ls_state, n_ls), reps=5)
    ls_bound, ls_bound_by = linesearch_bound_ms(T, 2, 1, 1, B, n_ls)
    say("time_linesearch", card=f"'{card}'", shape=f"n2m1e1_T{T}_B{B}_C{n_ls}_f32",
        kernel_ms=f"{ls_ms:.4f}", wrapper_call_ms=f"{ls_call_ms:.4f}",
        plain_ms=f"{ls_plain_ms:.4f}", bound_ms=f"{ls_bound:.5f}", bound_by=ls_bound_by,
        kernel_over_bound=f"{ls_ms / ls_bound:.1f}")  # fmt: skip
    # the whole solve in one launch (the plain version was timed once, in
    # phase 3)
    fs_plan = fs.plan_launch(p32, HEADLINE, x32, n_linesearch=n_ls)
    fs_ms = event_ms(lambda: fs.launch_plan(fs_plan))
    fs_call_ms = event_ms(lambda: fs.solve_flat(p32, HEADLINE, x32, n_linesearch=n_ls))
    p64 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float64)
    fs_plan64 = fs.plan_launch(p64, HEADLINE, headline_x0s(torch.float64), n_linesearch=n_ls)
    fs_f64_ms = event_ms(lambda: fs.launch_plan(fs_plan64), reps=5)
    fs_plain_ms = 1e3 * k3["fs_plain_s"]
    fs_bound, fs_bound_by = flat_solve_bound_ms(T, 2, 1, 1, B, HEADLINE.max_iterations, n_ls)
    say("time_flat_solve", card=f"'{card}'", shape=f"n2m1e1_T{T}_B{B}_C{n_ls}_f32",
        kernel_ms=f"{fs_ms:.4f}", wrapper_call_ms=f"{fs_call_ms:.4f}",
        kernel_f64_ms=f"{fs_f64_ms:.4f}", plain_ms=f"{fs_plain_ms:.1f}", bound_ms=f"{fs_bound:.5f}", bound_by=fs_bound_by,
        kernel_over_bound=f"{fs_ms / fs_bound:.1f}",
        chain_step_evaluations=flat_solve_chain_steps(T, HEADLINE.max_iterations, n_ls),
        us_per_chain_step=f"{1e3 * fs_ms / flat_solve_chain_steps(T, HEADLINE.max_iterations, n_ls):.4f}")  # fmt: skip
    for path, run in (
        ("A_forward_kernel_backward_kernel",
         lambda: solve_batched(p32, HEADLINE, x32, backward="kernel", forward="kernel",
                               **HEADLINE_KW)),
        ("B_solve_flat", lambda: fs.solve_flat(p32, HEADLINE, x32, n_linesearch=n_ls)),
    ):  # fmt: skip
        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        say("time_solve", card=f"'{card}'", path=path, B=B,
            solve_s=[f"{w:.5f}" for w in walls],
            solves_per_s=f"{B / statistics.median(walls):.1f}",
            peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    arm_packed, arm_mu, arm_reg = arm_in
    arm_kw = dict(T=ARM_H, n=14, m=7, e=3)
    arm_ms = event_ms(lambda: rs.backward_sweep(arm_packed, arm_mu, arm_reg, **arm_kw))
    arm_plain_ms = event_ms(
        lambda: rs.backward_sweep_reference(arm_packed, arm_mu, arm_reg, **arm_kw)
    )
    arm_bound, arm_bound_by = riccati_bound_ms(ARM_H, 14, 7, 3, ARM_B)
    say("time_backward", card=f"'{card}'", shape=f"n14m7e3_T{ARM_H}_B{ARM_B}_f32",
        kernel_ms=f"{arm_ms:.4f}", plain_ms=f"{arm_plain_ms:.4f}",
        bound_ms=f"{arm_bound:.5f}", bound_by=arm_bound_by)  # fmt: skip
    fd_ms = event_ms(lambda: fd.fd_derivs(panda32, *fd_in))
    fd_plain_ms = event_ms(lambda: fd.fd_derivs_reference(panda32, *fd_in))
    fd_model_ms = event_ms(lambda: panda32.fd_derivatives(*fd_in))
    fd_bound, fd_bound_by = fd_bound_ms(panda32, N)
    say("time_fd_derivs", card=f"'{card}'", shape=f"panda7_N{N}_f32", kernel_ms=f"{fd_ms:.4f}",
        plain_ms=f"{fd_plain_ms:.4f}", model_fd_derivatives_ms=f"{fd_model_ms:.4f}",
        bound_ms=f"{fd_bound:.5f}", bound_by=fd_bound_by,
        flops_per_sample=fd_flops(tuple(panda32.parents)),
        kernel_over_bound=f"{fd_ms / fd_bound:.1f}")  # fmt: skip
    arm_walls = {}
    for deriv, backward in (("kernel", "kernel"), ("jvp", "sweep")):
        arm_solve(a32, ax32, au32, deriv, backward)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            arm_solve(a32, ax32, au32, deriv, backward)
            walls.append(time.perf_counter() - t0)
        arm_walls[deriv] = statistics.median(walls)
        say("time_arm_solve", card=f"'{card}'", deriv=deriv, backward=backward, B=ARM_B,
            solve_s=[f"{w:.4f}" for w in walls],
            solves_per_s=f"{ARM_B / arm_walls[deriv]:.1f}",
            peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    arm2_packed, arm2_mu, arm2_reg = arm2_in
    rs2_ms = event_ms(lambda: rs.backward_sweep(arm2_packed, arm2_mu, arm2_reg, **arm_kw))
    rs2_plain_ms = event_ms(
        lambda: rs.backward_sweep_reference(arm2_packed, arm2_mu, arm2_reg, **arm_kw)
    )
    rs2_bound, rs2_bound_by = riccati_bound_ms(ARM_H, 14, 7, 3, ARM_B, second_order=True)
    say("time_backward_2nd_order", card=f"'{card}'", shape=f"n14m7e3_T{ARM_H}_B{ARM_B}_f32",
        kernel_ms=f"{rs2_ms:.4f}", plain_ms=f"{rs2_plain_ms:.4f}",
        bound_ms=f"{rs2_bound:.5f}", bound_by=rs2_bound_by,
        kernel_over_bound=f"{rs2_ms / rs2_bound:.1f}")  # fmt: skip
    fd2_ms = event_ms(lambda: fd2.fd_derivs2(panda32, *fd_in))
    fd2_plain_ms = event_ms(lambda: fd2.fd_derivs2_reference(panda32, *fd_in), reps=5)
    fd2_bound, fd2_bound_by = fd2_bound_ms(panda32, N)
    fd2_f64_in = tuple(x.double() for x in fd_in)
    fd2_f64_ms = event_ms(lambda: fd2.fd_derivs2(panda64, *fd2_f64_in), reps=5)
    say("time_fd_derivs2", card=f"'{card}'", shape=f"panda7_N{N}_f32", kernel_ms=f"{fd2_ms:.4f}",
        plain_ms=f"{fd2_plain_ms:.4f}", bound_ms=f"{fd2_bound:.5f}", bound_by=fd2_bound_by,
        flops_per_sample=fd2_flops(tuple(panda32.parents)),
        kernel_over_bound=f"{fd2_ms / fd2_bound:.1f}", kernel_f64_ms=f"{fd2_f64_ms:.4f}")  # fmt: skip
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ddp_stage(a2_32, ax32, gn_k, "kernel", "kernel")
        walls.append(time.perf_counter() - t0)
    ddp_wall = statistics.median(walls)
    say("time_arm_chain", card=f"'{card}'", deriv="kernel", backward="kernel", B=ARM_B,
        ddp_stage_s=[f"{w:.4f}" for w in walls],
        ddp_stage_solves_per_s=f"{ARM_B / ddp_wall:.1f}",
        chain_solves_per_s=f"{ARM_B / (arm_walls['kernel'] + ddp_wall):.1f}",
        ddp_stage_s_jvp_sweep=f"{chain['wall_jvp_sweep']:.4f}",
        chain_solves_per_s_jvp_sweep=f"{ARM_B / (arm_walls['jvp'] + chain['wall_jvp_sweep']):.1f}",
        peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    print(json.dumps({"kernels": [
        {
            "name": "riccati_small_bwd", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/riccati_small.cu",
            "replaces": "ddp_tpu/kernels/riccati_small.py:379",
            "launches": launches, "max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "arm_path": {
                "shape": f"n14m7e3_T{ARM_H}_B{ARM_B}_f32", "launches": arm_rs_launches,
                "ms": arm_ms, "plain_ms": arm_plain_ms, "bound_ms": arm_bound,
                "bound_by": arm_bound_by,
            },
        },
        {
            "name": "fd_derivs", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/fd_derivs.cu",
            "replaces": "ddp_tpu/kernels/fd_derivs.py:500",
            "launches": arm_fd_launches, "max_abs_err": fd_err32, "ms": fd_ms,
            "plain_ms": fd_plain_ms, "bound_ms": fd_bound, "bound_by": fd_bound_by,
            "library_ms": None,
        },
        {
            "name": "fd_derivs2", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/fd_derivs2.cu",
            "replaces": "ddp_tpu/kernels/fd_derivs2.py:357",
            "launches": fd2_launches, "max_abs_err": fd2_err32, "ms": fd2_ms,
            "plain_ms": fd2_plain_ms, "bound_ms": fd2_bound, "bound_by": fd2_bound_by,
            "library_ms": None,
        },
        {
            "name": "riccati_small_bwd_second_order", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/riccati_small.cu",
            "replaces": "ddp_tpu/kernels/riccati_small.py:379",
            "launches": rs2_launches, "max_abs_err": rs2_err32, "ms": rs2_ms,
            "plain_ms": rs2_plain_ms, "bound_ms": rs2_bound, "bound_by": rs2_bound_by,
            "library_ms": None,
        },
        {
            "name": "linesearch_flat", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/linesearch_flat.cu",
            "replaces": "ddp_tpu/kernels/linesearch_flat.py:321",
            "launches": ls_launches, "max_abs_err": k3["ls_err32"], "ms": ls_ms,
            "plain_ms": ls_plain_ms, "bound_ms": ls_bound, "bound_by": ls_bound_by,
            "library_ms": None, "wrapper_call_ms": ls_call_ms,
            "riccati_launches_on_its_path": ls_rs_launches,
        },
        {
            "name": "flat_solve", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/flat_solve.cu",
            "replaces": "ddp_tpu/kernels/flat_solve.py:690",
            "launches": fs_launches, "max_abs_err": k3["fs_err32"], "ms": fs_ms,
            "plain_ms": fs_plain_ms, "bound_ms": fs_bound, "bound_by": fs_bound_by,
            "library_ms": None, "wrapper_call_ms": fs_call_ms,
        },
    ]}))  # fmt: skip
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))  # fmt: skip


if __name__ == "__main__":
    main()
