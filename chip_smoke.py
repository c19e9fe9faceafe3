#!/usr/bin/env python3
"""Run ddp_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
2. build: every library the run loads, one nvcc (sm_90a) each, as many at
   once as the host has cores: csrc/riccati_small.cu at each (n, m, e) and
   order of RICCATI_SHAPES, csrc/fd_derivs.cu and csrc/fd_derivs2.cu at each
   joint count of FD_JOINTS (a library serves one shape, in float and
   double), csrc/linesearch_flat.cu and csrc/flat_solve.cu at each class
   (integrator, cost kind, E) of the problems the run gives them; prints
   nvcc's seconds for each.  No later phase compiles: main checks at the end that no
   library was added.
3. kernels vs their plain versions on the card, numpy-seeded inputs.
   Riccati, the whole reg ladder in one launch (ok and reg_used equal, gains
   within the bars): (n, m, e) = (2, 1, 1) at B=4096, T=32 in f32 and f64
   with one level, a ragged B=1000, one lane forced non-PD; (12, 6, 6) at
   B=512, T=16 and (14, 7, 3) at B=256, T=16 in f64 and f32 with 4 levels,
   (14, 7, 3) at a ragged B=1000; (12, 6, 12) at B=256, T=32 with 4 levels
   in f64 and f32 and with one level and lane 3 forced non-PD; with the
   second-order terms (non-zero rank-3 slabs) (2, 1, 1) at B=4096, T=32,
   (4, 2, 2) at a ragged B=1000, (14, 7, 3) at B=256, T=16 in f64 and f32,
   one lane forced non-PD, (12, 6, 6) at B=512, T=16 with 4 levels in f64
   and f32 and with one level and lane 3 forced non-PD, (2, 1, 2) at B=1000, T=30; and the
   ladder itself at (14, 7, 3) both orders, (12, 6, 12), (4, 2, 2) and
   (12, 6, 6) second order in both types: a lane that fails
   at reg and at the first escalation takes the second level, bit for bit
   what a launch at that level alone gives, and a lane no level saves keeps
   level 0's NaN gains and reg.
   fd-derivatives, first and second order: panda7 at N=4096 in f32 and f64,
   cartpole at N=4096 in f64, a ragged N=1000, UR5 (nv = 6) at N=8192 in
   f32 and f64 and at a ragged N=1000 in both; each output array is held to
   a bar relative to its largest entry, and the f32 kernel, row by row, to a
   multiple of the f32 plain version's distance from the f64 kernel; the
   second-order kernel's H must be exactly symmetric with exactly zero ττ
   and vτ blocks.
   Fused line search (kernel and plain version on a numpy-seeded state whose
   lanes accept different steps, B=4096, T=32): f64 constrained with 4, 7,
   31 and 1 candidates (xs, us within 1e-10 of the array's largest entry,
   every step equal), f32 constrained (2e-5; at least 99% of lanes on the
   same step), unconstrained (e = 0), a ragged B=1000, T=200 (bench.py's
   T200 row), every 7th lane anti-descent (those lanes step 0 and their
   trajectory back bit for bit, the others at the bars), and anti-descent
   gains on every lane in both types.  Whole solve on the headline
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
   kernels' launch counts (26 fd, 25 Riccati sweeping 4 levels each),
   finiteness and the feasible share, holds the share under
   matmul_precision="high" within 0.02 of "highest" and checks that the
   stages al.full_fp32_matmuls pins (the sweep backward, the adjoints,
   update_origin, both eager line searches) give the same bits with TF32
   allowed around them, then the same solve with
   deriv="jvp", backward="sweep", and both in f64 at 6 iterations (us within
   1e-7 of each lane's largest |u|, identical μ).
6. full second-order DDP on the arm (benchmarks/arm_second_order.py's
   recipe carried to panda7): phase 5's Gauss-Newton result warm-starts 4
   full-DDP iterations on the second_order twin of the problem
   (deriv="kernel": the second-order fd-derivatives kernel, backward="kernel":
   the Riccati kernel with its rank-3 terms, forward="seq", n_linesearch=4),
   and a cold 12-iteration full-DDP solve; checks both kernels' launch counts
   (6 fd2 and 5 Riccati sweeping 4 levels each per stage),
   finiteness, the chain's feasible share against the Gauss-Newton stage's,
   then the same stage through deriv="jvp", backward="sweep", and both in f64
   at 2 iterations (us within 1e-7 of each lane's largest |u|, identical μ).
7. quadrotor main path: bench.py's quaternion-manifold row (256 freeflyers
   to a state target at rest, H=32, f32, 36 AL iterations, inner_iters_max=3,
   8 candidates of forward="seq"), built from a numpy spec through
   convert.problem_from_numpy, through solve_batched with backward="kernel"
   (the Riccati kernel at (12, 6, 12), 37 launches sweeping 4 levels each, no
   other kernel); checks finiteness, every terminal quaternion's norm within
   1e-5 of 1, the feasible share against ddp_tpu's for the same recipe on the
   CPU (0.9921875) less 0.01, then the same solve with backward="sweep"
   (shares within 0.01), and both in f64 at 16 lanes for 6 iterations (us
   within 1e-7 of each lane's largest |u|, identical μ).
8. ddp_tpu_torch.solve on the card: the golden file's configuration
   (pendulum, T=200, full DDP, f64, SolverParams(200, 1e-9, mu=1e8), x0 = 0)
   converged in ≤ 200 iterations within 1e-9 (us) and 1e-11 (xs) of
   tests/golden_pendulum_reference.npz, and tests/test_model_zoo.py's
   quadrotor solve (f64, H=24, opt_constr < 1e-3); wall times.
9. the UR5 chain: benchmarks/arm_second_order.py's recipe at full size
   (512 UR5 arms to the configuration q0 ⊕ 0.05·(1 … 6) two steps past H=16,
   f32, x0 = rest + 0.1·N(0, 1)): 8 Gauss-Newton iterations through
   deriv="kernel", backward="kernel", forward="seq", n_linesearch=4,
   matmul_precision="high" (10 fd and 9 Riccati launches at (12, 6, 6)), then
   4 full-DDP iterations warm-started on them (6 fd2 and 5 second-order
   Riccati launches), each stage's counts exact; the Gauss-Newton share
   against ddp_tpu's on the CPU (1.0) less 0.01, the chain's against the
   Gauss-Newton share less 0.01, finite results; the same chain through
   jvp/sweep (shares within 0.02), both routes in f64 at 16 lanes (us within
   1e-7 of each lane's largest |u|, identical μ).
10. the UR5 MPC replan (bench.py's: the chain's Gauss-Newton problem at
   B=1, 3 AL iterations) through make_mpc_step on the default route
   (backward="sweep") and through the Riccati kernel (backward="kernel", 4
   launches a replan): a warm-up, then 6 replans from x0 at rest with the
   carry carried, each timed to a torch.cuda.synchronize (p50, p99);
   finite u0 and carry; both routes in f64 for 6 replans (u0 within 1e-7 of
   |u0|, identical μ); run_mpc and the closed loop of both routes for 5
   steps in f64 (each step's states within 1e-7 of their scale, or within
   what 1e-15 on x0 does to the sweep route's, whichever is larger); and
   test_aux_subsystems.py's pendulum receding-horizon loop (a StateTarget at
   H=30, full DDP, 120 replans, f64) through the kernel at (2, 1, 2) second
   order, ending within 0.02 of q = 3.14 with |v| < 0.1.
11. times: each kernel vs its plain version at its main-path shape (CUDA
   events around one call, median of 20; the line search's plain version
   median of 5 and the second-order fd's of 2 (f64 and on UR5 one call: a
   call takes seconds; a plain version phase 3 ran on the same inputs is
   timed without a warm-up call); the whole solve's plain version is
   the one run of phase 3; the line-search kernel also by its device time
   alone, 50 launches queued behind a sleep kernel), each beside its bound —
   the Riccati ladder at (2, 1, 1), at (14, 7, 3) in both orders and types
   and at (12, 6, 6) in both orders (f32, device time alone too) and types,
   at one lane as the MPC replans launch it ((12, 6, 6) f32, (2, 1, 2)
   second order f64), on a launch plan and through its wrapper; the fd kernels on panda7 and on
   UR5 — and solves/s of the main paths, paths A and B included (median of
   3 after a warm-up; the arm's routes by phase 5's checked solves; the
   arm's full-DDP stage one solve), of the UR5 chain on both routes (phase
   9's chains).
12. the associative-scan backward and the precision envelope: (a) the
   headline through backward="assoc" (no Riccati launch; the share against
   ddp_tpu's on the CPU less 0.01; ≥ 99% of lanes within 1e-3 of their
   largest |u| of the kernel route; the scan's bits with TF32 allowed around
   it; f64 at 16 lanes against the sweep within 1e-8, identical μ); (b)
   bench.py's T200 row (H = 200, forward="seq") through assoc, sweep and
   kernel, one timed solve each, shares, lane agreement with the
   kernel route (at least ddp_tpu's own routes' agreement there less 0.02:
   0.9714 and 0.9690 on the CPU); path B (solve_flat, #5's streamed program:
   exactly 1 launch, the share against ddp_tpu's less 0.01, f32 agreement
   with the sweep route against 0.9690 less 0.02, f64 at 64 lanes within
   1e-8 of each lane's |u| of the sweep route with identical μ; the kernel
   timed beside its bound, its launch plan), kernel #1 against its plain version on
   the kernel route's finished inputs (f64 copies at 1e-10; f32, which
   those inputs are beyond at phase 3's bars, no further from f64 than 2×
   the plain f32 version), and each backward's call on those inputs at
   T = 200 (CUDA events; the device kernels of one call and their device
   time by torch.profiler); (c) the headline through backward="tf" with
   precise_cost=True (share ≥ 0.99) and one tf backward call on its finished
   inputs against kernel #1's float64 instantiation at (2, 1, 1) on float64
   copies (one launch; ok and reg_used equal, gains within 2·eps32 of each
   array's largest entry), with the times of the tf call and of the f32 and
   f64 kernels; (d) ddp_tpu_torch.solve(precise=True) and
   precise="storage" on tests/test_precise.py's T = 60 configuration beside
   the plain f32 solve from 22 starts (in worker processes of one intra-op
   thread each), at its anchors' bars on q_T and opt_constr; the
   anchors' opt_lag bars are draws, in ddp_tpu too, so the envelope must
   beat the plain solve and the storage mode reach 1e-8 from at least as
   many starts as ddp_tpu does on the CPU, less two binomial standard
   deviations (5 and 10 of 22).
13. the sharded paths (parallel/mesh.py, solve_vmap, make_batch_mpc_step,
   entry.py): (a) world size 1 over NCCL in this process: the headline
   through batch_sharded_solve_batched(backward="kernel") (9 launches of
   #1; us, μ and opt_constr bit for bit the unsharded solve_batched's,
   mean_constr the local mean; solves/s beside the unsharded),
   dryrun_multichip(1)'s contract run (share > 0.99), batch_sharded_solve on
   entry()'s problem at B=4096 (share not below the unsharded solve_vmap's;
   4 lanes in f64 within 1e-8 of the per-trajectory solve, identical
   iterations and μ), and BASELINE configs[4]'s fleet replan,
   make_batch_mpc_step at B=32,768 through #1 (a warm-up and 10 timed
   replans, 4 launches each, p50/p99 beside the 10 ms budget, which is a
   record, not a bar; #1 at that shape, 4 reg levels, against its plain
   version in f32 and f64 and timed); (b) world size 2 on the one card over gloo (spawned
   ranks, both on cuda:0): the same three functions, each rank's launches,
   f32 ≥ 99% of lanes within 1e-3 of their largest |u| of (a)'s, f64 at 64
   lanes within 1e-9 with identical μ, mean_constr within 1e-6/1e-12
   relative; (c) a line saying NCCL across cards stays unverified.
14. give_up_after and the examples: (a) phase 5's arm fleet with lanes 3,
   77, 140 and 201 started at μ = ∞ (terminal racers), solved with
   give_up_after None and 3 in turns (none, give-up, none): every
   solve's launches phase 5's (26 fd, 25 Riccati sweeping 4 levels), the
   lanes that never gave up bit for bit the same (bar: the spread of the two
   solves without it), the racers at μ = ∞ with every step 0, finite
   controls and their reg constant from row 2; the rollouts, walls and
   feasible shares are records; (b) ddp_tpu's own give-up case (4
   pendulums, T = 100, lane 0 at μ = ∞, f64) through the kernel and the
   sweep (healthy lanes within 1e-8 of their |u|, 13 launches) and both
   ValueErrors; (c) examples/torch_pendulum_swingup.py in f32 (|eq| < 1e-2)
   and f64 (ddp_tpu's converged flag, final q within 1e-6, |eq| ≤ 10×
   ddp_tpu's on the CPU), examples/torch_ur5_reach.py in f64 (the reached
   point within 1e-6 m of ddp_tpu's, |eq| ≤ 10×) and
   examples/torch_mpc_fleet.py at B = 512 (finite u0, 7 launches of #1 a
   replan, mean |eq| ≤ 10× ddp_tpu's), each through its main() at full size.
15. BASELINE configs[2], benchmarks/double_pendulum_reach.py's recipe
   (2048 double pendulums to q = (0.8, -0.5) two steps past H = 32, f32, 12
   AL iterations, 8 candidates of forward="seq" under "high", 4 reg levels)
   through deriv="kernel", backward="kernel": (c) #2 at nv = 2 and #1 at
   (4, 2, 2) Gauss-Newton, shapes no library had before, launched exactly
   14 and 13 times (52 levels), the feasible share against ddp_tpu's on the
   CPU (0.99951171875) less 0.01, the same recipe through jvp/sweep, both
   routes in f64 at 64 lanes and 6 iterations (us within 1e-7 of each
   lane's largest |u|, identical μ), solves/s of both (a record); (a) #1 at
   (4, 2, 2) against its plain version on the inputs of the path's first
   backward call at
   phase 3's bars (f32 2e-3/2e-4, f64 1e-9; ok and reg_used equal) and on
   its last call's (the finished solve's), where float32 resolves neither
   the gains nor every lane's level (μ up to 1e11: each f32 order's gains
   lie 1e2-1e4 from float64's): there f64 copies are held to the plain f64
   version within 1e-6 of each array's largest entry (another summation
   order, _backward_multi_reg's, lands 1.1e-8 from it on the CPU), ok and
   reg_used equal, and f32 to ok equal,
   finite gains and at most twice the other order's count of lanes on
   another level (its gains' distances from f64 reported); timed there
   (events, wrapper call, device time alone, plain, bound), the kernel
   route's solve timed once more after its checked one; and at (6, 3, 3)
   both orders and (12, 6, 12) second
   order on seeded SPD inputs in both types; (b) #2 and #3 on a
   three-revolute arm (nv = 3) and #2 on the double pendulum at
   N = B·H = 65,536 in both types against their plain versions at phase 3's
   fd bars, #2 there timed.
16. the flat-lane class of #4 and #5 (flat_class_spec): (a) at B=4096,
   T=32 against their plain versions at phase 3's bars, f64 and f32: the
   arrive-at-rest StateTarget under two layers (#4 at 4 and 7 candidates,
   #5), RK4 with the quadratic tracking cost (#4, #5), a trajectory target on
   in_range under one layer (#4; #5 refuses it, "single-active-step"), a
   stack of a ConfigTarget and a StateTarget (e = 3; #4, #5), the manifold
   tracking cost with a ConfigTarget on every_k (#4), and in f64 a
   StateTarget behind an RK4 layer of another pendulum (#4, #5); each
   timed beside its bound recounted for the class (flat_ops); #5 with
   SolverParams' μ and multiplier caps binding (HEADLINE_CAPS) in f64 at
   B=4096 (the streamed program) and B=1000 (the resident one), and the
   streamed program on the f32 headline, where the plan picks the other; #1 at the
   new Gauss-Newton shapes (2, 1, 2) at T=100 and (2, 1, 3) against its
   plain version, timed; (b) the arrive-at-rest fleet (4096 pendulums to
   [3.14, 0] two steps past T=100, Euler dt 0.01, 30 iterations, f32)
   through the sweep route, path A (31 + 31 launches) and path B (1
   launch): feasible share against ddp_tpu's on the CPU less 0.01, f32
   lane agreement with the sweep route against ddp_tpu's own sweep/assoc
   agreement less 0.02, f64 at 64 lanes and 8 iterations within 1e-8 of
   each lane's |u| with identical μ, wall and solves/s of each route, #5 on
   a launch plan of the fleet timed beside its bound;
   (c) the RK4 tracking twin at T=20, 16 iterations through path B (1
   launch; a non-zero terminal cost) against the sweep route, ≥ 99% of
   lanes in f32, f64 at 64 lanes within 1e-8, identical μ, #5 timed beside
   its bound.  Every #5 case prints the kernel's launch plan (program,
   threads a lane, lanes a block and an SM, waves).

Every phase prints one line (phase 3 one a case); any failure raises and
the exit code is not 0.
The last lines are a JSON object describing the kernels and the JSON result
{"ok": true, "device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from operator import attrgetter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
from torch.distributed.tensor import DTensor, Shard

from ddp_tpu_torch import entry as entry_mod
from ddp_tpu_torch import solve as ddp_solve
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import fd_derivs2 as fd2
from ddp_tpu_torch.kernels import flat_solve as fs
from ddp_tpu_torch.kernels import linesearch_flat as lsf
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.kernels.flat_problem import LEAF_ROWS, pack_problem
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.base import state_integrate, state_pack
from ddp_tpu_torch.models.rigid_body import build_model, double_pendulum
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.ocp.problem import Derivs
from ddp_tpu_torch.parallel import mesh as pmesh
from ddp_tpu_torch.solver import al
from ddp_tpu_torch.solver.batched import (
    _backward_multi_reg,
    _backward_sweep,
    _linesearch_seq,
    _linesearch_sweep,
    _reg_levels,
    solve_batched,
)
from ddp_tpu_torch.solver import mpc
from ddp_tpu_torch.solver import precise
from ddp_tpu_torch.solver.parallel_riccati import backward_pass_assoc
from ddp_tpu_torch.solver.solve import SolverParams, solve_vmap

B, T = 4096, 32
HEADLINE = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
HEADLINE_KW = dict(n_reg_levels=1, n_linesearch=4)
# the μ and multiplier caps of SolverParams on the headline (phase 16a):
# both bind there (μ would reach 1e9, the multipliers' Jacobians 5e7), and
# every lane stays feasible, so float64 resolves the solve (a 1e-15 change
# of x0 moves xs by 1e-14 of its scale on the CPU; at μ ≤ 1e6 and
# multipliers ≤ 1e3 most lanes stay infeasible and the same change moves
# xs by 1.6e-9)
HEADLINE_CAPS = HEADLINE._replace(mu_max=1e7, mult_max=1e5)
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
# bench.py's quadrotor row: 256 freeflyers to a state target at rest, H=32,
# 36 AL iterations, f32, the Riccati kernel at (12, 6, 12)
QUAD_B, QUAD_H, QUAD_B64 = 256, 32, 16
QUAD = SolverParams(max_iterations=36, threshold=1e-5, mu=1e4, inner_iters_max=3)
# the f64 routes' parity at a sixth of the row's depth, to keep the whole run
# well inside its time limit
QUAD64 = QUAD._replace(max_iterations=4)
QUAD_KW = dict(n_linesearch=8, forward="seq", matmul_precision="highest")
QUAD_REG_LEVELS = 4  # solve_batched's default ladder depth
# ddp_tpu's feasible share (opt_constr < 1e-2) for the same recipe on the
# CPU (backward="sweep", jit, f32): tests/test_torch_reference_draws.py
# quadrotor_share
QUAD_JAX_CPU_SHARE = 0.9921875
# benchmarks/arm_second_order.py's UR5 chain: 512 arms to the configuration
# q0 ⊕ 0.05·(1 … 6) at H=16, f32, 8 Gauss-Newton iterations, then 4 full-DDP
# iterations warm-started on them; its f64 route check at 16 lanes
UR5_B, UR5_H, UR5_B64 = 512, 16, 16
UR5_GN = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
UR5_DDP = SolverParams(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)
UR5_KW = dict(n_linesearch=4, forward="seq", matmul_precision="high")
UR5_REG_LEVELS = 4  # solve_batched's default ladder depth
# ddp_tpu's feasible share after the Gauss-Newton stage on the CPU (jvp/sweep,
# jit, f32): tests/test_torch_reference_draws.py ur5_share
UR5_JAX_CPU_SHARE = 1.0
# bench.py's UR5 MPC replan: the chain's Gauss-Newton problem at B = 1, 3 AL
# iterations a replan, timed replans from x0 at rest with the carry carried
MPC = SolverParams(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
# (timed replans and closed-loop steps, few enough to keep the whole run well
# inside its time limit)
MPC_REPLANS, MPC_LOOP_STEPS = 6, 5
# test_aux_subsystems.py::test_mpc_receding_horizon's pendulum loop
PEND_MPC = SolverParams(max_iterations=4, threshold=1e-6, mu=1e6)
PEND_MPC_H, PEND_MPC_REPLANS = 30, 120
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden_pendulum_reference.npz"
# phase 12: ddp_tpu's feasible shares for the headline recipe on the CPU (jit,
# f32; tests/test_torch_reference_draws.py assoc_share and tf_share): through
# backward="assoc" at T = 32 and on the T200 row, and through backward="tf"
# with precise_cost=True
ASSOC_JAX_CPU_SHARE = 1.0
ASSOC_T200_JAX_CPU_SHARE = 1.0
TF_JAX_CPU_SHARE = 1.0
# how many lanes ddp_tpu's own assoc and sweep routes leave within 1e-3 of
# their largest |u| of its Pallas route on the T200 row (the same script's
# assoc_share; 1.0 for both at T = 32): in float32 at T = 200 roundoff parts
# the μ paths of a few percent of lanes in the reference itself, so the
# headline's 0.99 is out of its reach there, and the port's routes are held
# to the reference's own agreement less 0.02
T200_JAX_CPU_AGREE = dict(assoc=0.971435546875, sweep=0.968994140625)
# bench.py's T200 row: the headline recipe at H = 200 with forward="seq"
T200 = 200
T200_KW = dict(HEADLINE_KW, forward="seq")
# tests/test_precise.py's T = 60 configuration for solve(precise=…) from the
# 22 starts of precise_starts(); the anchors' opt_lag bars are draws there
# (roundoff parts the schedule's paths): from those starts on the CPU
# ddp_tpu's envelope ends below its plain solve from 9 and its storage mode
# below 1e-8 from 14 (tests/test_torch_reference_draws.py precise_draws).
# Phase 12d holds the port on the card to those counts less two standard
# deviations of a binomial at the reference's rate (sqrt(22·p·(1-p)) = 2.31
# and 2.26): a port that converges systematically less often fails, a
# draw does not
PRECISE_JAX_CPU_ENVELOPE_BELOW, PRECISE_JAX_CPU_STORAGE_MET = 9, 14
ENVELOPE_MIN_BELOW, STORAGE_MIN_MET = 5, 10
# processes that solve the starts after x0 = 0 (one card; the host's cores)
PRECISE_WORKERS = 8
PRECISE_H = 60
# phase 13: BASELINE configs[4]'s fleet MPC ("32k scenarios across N >= 2
# hosts, 10 ms replan budget"): the headline problem at B = 32,768 through
# make_batch_mpc_step and #1, 3 AL iterations a replan (bench.py's replan
# recipe); the budget is a record, not a bar (the eager replan is host-bound)
FLEET_B, FLEET_REPLANS, FLEET_BUDGET_MS = 32768, 10, 10.0
FLEET = SolverParams(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
FLEET_LAUNCHES = 1 + FLEET.max_iterations  # the pre-loop backward and one an iteration
# lanes of the f64 checks: the per-trajectory solve against solve_vmap; the
# two-rank split against world size 1 (and its fleet replans)
ENTRY_B64, SPLIT_B64, SPLIT_FLEET_REPLANS = 4, 64, 3
# phase 14a: the arm fleet of phase 5 with four lanes started at μ = ∞ (the
# limit of the μ·10 race: every candidate rejected, no step ever accepted),
# solved without and with give_up_after
RACERS, GIVE_UP = (3, 77, 140, 201), 3
# phase 14b: ddp_tpu's test_give_up_after_freezes_racing_lane_only
# (tests/test_batched_solver.py): 4 pendulums at T = 100, lane 0 at μ = ∞
GU_PEND = SolverParams(max_iterations=12, threshold=1e-9, mu=1e8)
GU_PEND_H, GU_PEND_Q0 = 100, (-0.4, 0.0, 0.3, 0.5)
# phase 14c: what ddp_tpu's examples give on the CPU
# (tests/test_torch_reference_draws.py examples): examples/pendulum_swingup.py
# in f32 and f64, examples/ur5_reach.py, and examples/mpc_fleet.py's recipe on
# one device at B = 512 (through backward="sweep": its "pallas" needs
# interpret mode on the CPU) after its 41 replans
PEND_JAX_CPU = {
    torch.float32: dict(converged=False, iterations=60, q=3.140000104904175, eq=0.0),
    torch.float64: dict(converged=True, iterations=33, q=3.1400000000000072, eq=7.105427357601002e-15),
}
UR5_JAX_CPU = dict(reached=(0.7497957295496186, 0.3469154235766152, 0.07762458192760813),
                   eq=1.1495205438356883e-07, iterations=55)  # fmt: skip
FLEET_JAX_CPU_MEAN_EQ = 1.0395469143986702e-04
EXAMPLES = Path(__file__).resolve().parent / "examples"
# phase 15: BASELINE configs[2], benchmarks/double_pendulum_reach.py's
# recipe: 2048 double pendulums to q = (0.8, -0.5) two steps past H = 32, f32,
# 12 AL iterations, 8 candidates of forward="seq" under "high", the default
# 4 reg levels: #2 at nv = 2 over B·H = 65,536 samples and #1 at (4, 2, 2)
# Gauss-Newton; its f64 route check at 64 lanes
DP_B, DP_H, DP_B64 = 2048, 32, 64
DP = SolverParams(max_iterations=12, threshold=1e-5, mu=1e4, inner_iters_max=1)
# the f64 route check at half the recipe's depth, as phase 5's arm, to keep
# the whole run inside its time limit
DP64 = DP._replace(max_iterations=6)
DP_KW = dict(n_linesearch=8, forward="seq", matmul_precision="high")
DP_REG_LEVELS = 4  # solve_batched's default ladder depth
DP_TARGET = (0.8, -0.5)
# ddp_tpu's feasible share for the recipe on the CPU (jvp/sweep, jit, f32):
# tests/test_torch_reference_draws.py double_pendulum_share
DP_JAX_CPU_SHARE = 0.99951171875
# phase 16: the flat-lane class of #4 and #5 (16a: each class against the
# plain versions at B = 4096, T = 32; flat_class_spec), the arrive-at-rest
# fleet (16b: 4096 pendulums to the state [3.14, 0] two steps past T = 100,
# Euler dt = 0.01, ½‖u‖², 30 iterations, f32; its f64 check at 64 lanes and
# 8 iterations, where μ stays below ~1e9) and the RK4 tracking twin through
# path B (16c: T = 20, 16 iterations, f32; f64 at 64 lanes)
FLAT_CLASSES = ("state", "rk4_tracking", "trajectory", "stack", "manifold", "in_range")
FS_CLASSES = ("state", "rk4_tracking", "stack", "in_range")  # one active step: #5 takes them
STATE_T, STATE_B64 = 100, 64
STATE = SolverParams(max_iterations=30, threshold=1e-5, mu=1e4, inner_iters_max=1)
STATE64 = STATE._replace(max_iterations=8)
# ddp_tpu on the CPU for 16b's recipe (jit, f32; tests/test_torch_reference_draws.py
# state_fleet): its feasible share, and how many lanes its backward="sweep"
# and "assoc" routes leave within 1e-3 of their largest |u| of each other —
# with μ uncapped (~1e22 by iteration 30) roundoff parts most lanes' μ
# paths in the reference itself, so the f32 lane agreement bar of paths A
# and B (the reference's own agreement less 0.02) holds them to nothing
# there; the parity checks of the recipe run at 8 iterations (μ ≤ 1e9): f64
# at 64 lanes, and f32 on every lane against 16a's plain f64 solve
STATE_JAX_CPU_SHARE = 1.0
STATE_JAX_CPU_AGREE = 0.012939453125
TRACK_T, TRACK_B64 = 20, 64
TRACK = SolverParams(max_iterations=16, threshold=1e-5, mu=1e4, inner_iters_max=1)
# every library the run loads, each built by its own nvcc in phase 2 so that
# no later phase includes a compile (main checks that none was added):
# #1 at (n, m, e) and order, #2 and #3 at a joint count, #4 and #5 at the
# classes (integrator, cost kind, E) of the problems the run gives them
RICCATI_SHAPES = (
    (2, 1, 1, False), (2, 1, 2, False), (2, 1, 3, False), (4, 2, 2, False), (6, 3, 3, False),
    (12, 6, 6, False), (12, 6, 12, False), (14, 7, 3, False), (2, 1, 1, True), (2, 1, 2, True),
    (4, 2, 2, True), (6, 3, 3, True), (12, 6, 6, True), (12, 6, 12, True), (14, 7, 3, True),
)  # fmt: skip
FD_JOINTS = (2, 3, 6, 7)


def flat_class_spec(name, Tk):
    """``convert.problem_from_numpy``'s spec of one problem of the flat-lane
    class at horizon ``Tk`` (≙ tests/torch_parity_helpers.py's): "headline"
    (SPEC) and "e0" (its unconstrained twin); "state": StateTarget([3.14, 0])
    at Tk under two AdvanceTime layers (e = 2); "rk4_tracking": RK4 dt = 0.05
    with QuadTrackingCost(x_ref = [3.14, 0], q = [1, 0.1], r = [0.01],
    qf = [100, 10]), unconstrained; "trajectory": TrajectoryConfigTarget
    q_ref[t] = 3.14·t/Tk on in_range(1, Tk + 1) under one layer; "stack":
    StackConstraints(ConfigTarget, StateTarget) at Tk under two layers
    (e = 3); "manifold": ManifoldTrackingCost with a ConfigTarget on
    every_k(4, offset=3) under one layer; "in_range": StateTarget on
    in_range(Tk, Tk + 1) under two layers, the outer one RK4 dt = 0.02 of a
    pendulum of mass 1.2 and length 0.9."""
    if name in ("headline", "e0"):
        return dict(SPEC, active_ts=(Tk,), horizon=Tk, target=SPEC["target"] if name == "headline" else None)
    spec = dict(mass=1.0, length=1.0, dt=0.01, horizon=Tk, second_order=False,
                cost=dict(kind="quad_control", c=1.0))  # fmt: skip
    state = dict(kind="state", target=[3.14, 0.0], active_ts=(Tk,), advance_times=2)
    if name == "state":
        spec["constraint"] = state
    elif name == "rk4_tracking":
        spec.update(dt=0.05, discretization="rk4", constraint=dict(kind="none"),
                    cost=dict(kind="quad_tracking", x_ref=[3.14, 0.0], q_diag=[1.0, 0.1],
                              r_diag=[0.01], qf_diag=[100.0, 10.0]))  # fmt: skip
    elif name == "trajectory":
        spec["constraint"] = dict(
            kind="trajectory_config", targets=(3.14 * np.arange(Tk + 1) / Tk)[:, None],
            active_ts={"in_range": (1, Tk + 1)}, advance_times=1,
        )  # fmt: skip
    elif name == "stack":
        config = dict(kind="config", target=[3.14], active_ts=(Tk,), advance_times=2)
        spec["constraint"] = dict(kind="stack", parts=[config, state])
    elif name == "manifold":
        spec["cost"] = dict(kind="manifold_tracking", x_ref=[3.14, 0.0], q_diag=[1.0], v_diag=[0.1],
                            r_diag=[0.01], terminal_scale=10.0)  # fmt: skip
        spec["constraint"] = dict(kind="config", target=[3.14], active_ts={"every_k": 4, "offset": 3},
                                  advance_times=1)  # fmt: skip
    else:
        other = dict(discretization="rk4", dt=0.02, mass=1.2, length=0.9)
        spec["constraint"] = dict(state, active_ts={"in_range": (Tk, Tk + 1)},
                                  advance_dynamics=[other, None])  # fmt: skip
    return spec


def flat_builds(names):
    """The distinct build constants of the classes ``names``."""
    out = []
    for name in names:
        problem = problem_from_numpy(flat_class_spec(name, T), device="cpu", dtype=torch.float32)
        if (build := pack_problem(problem).build) not in out:
            out.append(build)
    return out


def precise_starts():
    """x0 = 0, five axis perturbations and 16 seeded ones, float32 (the
    starts of tests/test_torch_reference_draws.py precise_draws)."""
    rng = np.random.default_rng(1)
    axis = ([0.0, 0.0], [1e-6, 0.0], [0.0, 1e-6], [-1e-6, 0.0], [1e-5, 0.0], [0.0, -1e-5])
    seeded = [s * rng.standard_normal(2) for s in (1e-6, 1e-5) for _ in range(8)]
    return [np.asarray(x, np.float32) for x in (*axis, *seeded)]


# published peaks of one H100 SXM used for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores
F64_FLOPS_PER_S = 34e12  # outside the tensor cores (NVIDIA's H100 SXM data sheet)


T_START = time.perf_counter()


def say(phase, **fields):
    """One line of the run's output, ending in the seconds since the start."""
    fields["t"] = f"{time.perf_counter() - T_START:.1f}"
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
    multipliers (≙ tests/test_pallas_riccati.py's make_batch): ((derivs,
    mult_val, mult_jac), mu, reg), batch-major."""
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
    return (derivs, val, jac), mu, reg


def spd_inputs(Bk, Tk, n, m, e, dtype, second_order=False, bad_lane=None, ladder=False):
    """Random blocks at arbitrary dims: fx near I, an SPD stage-cost Hessian,
    non-trivial constraint rows and multipliers; with ``second_order`` also
    non-zero symmetric dynamics and constraint Hessian slabs (small against
    the cost Hessian, so Quu stays PD).  ``bad_lane``: that lane's luu is made
    negative definite.  ``ladder``: lane 1's luu is −5e3·I, so at μ = 1e3 it
    fails at reg and at the ladder's first escalation (2e3) and holds at its
    second (3.2e4), and lane 2's is −1e9·I, which no level saves.  Returns
    ((derivs, mult_val, mult_jac), mu, reg), batch-major."""
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
    f["luu"] = f["luu"].copy()
    if bad_lane is not None:
        f["luu"][bad_lane] = -10.0 * np.eye(m)
    if ladder:
        f["luu"][1] = -5e3 * np.eye(m)
        f["luu"][2] = -1e9 * np.eye(m)
    kw = dict(dtype=dtype, device=DEV)
    derivs = Derivs(**{k: torch.tensor(np.ascontiguousarray(v), **kw) for k, v in f.items()})
    pe = torch.tensor(0.3 * rng.normal(size=(Bk, Tk, e)), **kw)
    pex = torch.tensor(0.01 * rng.normal(size=(Bk, Tk, e, n)), **kw)
    mu = torch.full((Bk,), 1e3, **kw)
    reg = torch.full((Bk,), 1e-6, **kw)
    return (derivs, pe, pex), mu, reg


def kernel_vs_plain(name, inputs, mu, reg, n_levels, rtol, atol, second_order=False):
    """Run the Riccati ladder kernel (``n_levels`` levels of
    ``_reg_levels``, one launch) and its plain version on the same card
    tensors; raise unless ok and reg_used are equal and k, K agree within
    (rtol, atol) on the lanes some level saved.  Returns the max abs error,
    the ok vector and the kernel's outputs."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    before = (rs.LAUNCHES, rs.LEVELS_SWEPT)
    got = rs.backward_ladder(*inputs, mu, levels, second_order)
    torch.cuda.synchronize()
    check((rs.LAUNCHES, rs.LEVELS_SWEPT) == (before[0] + 1, before[1] + n_levels),
          f"{name}: the wrapper did not launch its kernel once")  # fmt: skip
    ref = rs.backward_ladder_reference(*inputs, mu, levels, second_order)
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    check(torch.equal(got[3], ref[3]), f"{name}: reg_used differs")
    err = 0.0
    for a, b, label in zip(got[:2], ref[:2], ("k", "K")):
        keep = ref[2]  # lanes no level saved are NaN in both
        a, b = a[keep], b[keep]
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {label}")
        check(
            torch.allclose(a, b, rtol=rtol, atol=atol),
            f"{name}: {label} max err {float((a - b).abs().max())}",
        )
        err = max(err, float((a - b).abs().max()))
    say("kernel", case=name, levels=n_levels, max_abs_err=f"{err:.3e}", rtol=rtol, atol=atol,
        ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}",
        lanes_per_level=torch.bincount((levels == got[3]).int().argmax(0), minlength=n_levels).tolist())  # fmt: skip
    return err, got[2], got


def kernel_f32_vs_f64(name, inputs, mu, reg, n_levels):
    """Kernel #1 in f32 on inputs f32 does not resolve to phase 3's bars (a
    finished solve's at T = 200: the plain f32 version's k is up to 1.2 off
    float64 there, 3% of a lane's largest entry): one launch, ok and
    reg_used equal to the plain f32 version's, and each of k, K no further
    from the plain float64 version on float64 copies of the inputs than
    FD_F32_VS_PLAIN times the plain f32 version is (max over the lanes both
    save).  Returns (the kernel's and the plain f32 version's max abs
    distance from float64, the kernel's max abs difference from the plain
    f32 version)."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    before = (rs.LAUNCHES, rs.LEVELS_SWEPT)
    got = rs.backward_ladder(*inputs, mu, levels)
    torch.cuda.synchronize()
    check((rs.LAUNCHES, rs.LEVELS_SWEPT) == (before[0] + 1, before[1] + n_levels),
          f"{name}: the wrapper did not launch its kernel once")  # fmt: skip
    ref = rs.backward_ladder_reference(*inputs, mu, levels)
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    check(torch.equal(got[3], ref[3]), f"{name}: reg_used differs")
    wide = (precise.wide(inputs[0]), inputs[1].double(), inputs[2].double())
    truth = rs.backward_ladder_reference(*wide, mu.double(), levels.double())
    keep = ref[2] & truth[2]
    dist, diff = {}, 0.0
    for i, label in enumerate(("k", "K")):
        w = truth[i][keep]
        check(bool(torch.isfinite(got[i][keep]).all()), f"{name}: non-finite {label}")
        k_err = float((got[i][keep].double() - w).abs().max())
        p_err = float((ref[i][keep].double() - w).abs().max())
        check(k_err <= FD_F32_VS_PLAIN * p_err,
              f"{name}: {label} {k_err:.3e} from f64, the plain f32 version {p_err:.3e}")  # fmt: skip
        dist[label] = (k_err, p_err)
        diff = max(diff, float((got[i][keep] - ref[i][keep]).abs().max()))
    say("kernel", case=name, levels=n_levels, max_abs_err=f"{diff:.3e}",
        **{f"{lb}_from_f64_kernel": f"{k:.3e}" for lb, (k, _) in dist.items()},
        **{f"{lb}_from_f64_plain": f"{p:.3e}" for lb, (_, p) in dist.items()},
        bar=f"{FD_F32_VS_PLAIN}x plain", ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}")  # fmt: skip
    return max(k for k, _ in dist.values()), max(p for _, p in dist.values()), diff


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


def linesearch_inputs(Bk, dtype, constrained=True, anti_descent=False, Tk=T, reject_every=None,
                      spec=None):
    """A line-search state on the card (≙ tests/test_pallas_linesearch.py's
    make_state, numpy-seeded): the pendulum at horizon ``Tk`` with a target of
    2.0 (or unconstrained), a rollout from random x0s and us, random
    multipliers anchored at it, μ = 1e3, the gains of a backward sweep at
    reg = 0 with lane i's k times GAIN_SCALES[i % 8]; ``anti_descent``: k =
    1e3, K = 0 on every lane, or ``reject_every``: on every such lane from
    lane 0; ``spec``: that problem instead of the pendulum's (its horizon
    ``Tk``).  Returns (problem, (xs, us, k, K, mult_val, mult_jac, mu))."""
    rng = np.random.default_rng(7)
    if spec is None:
        spec = dict(SPEC, target=np.array([2.0]) if constrained else None, active_ts=(Tk,),
                    horizon=Tk)  # fmt: skip
    problem = problem_from_numpy(spec, device=DEV, dtype=dtype)
    kw = dict(dtype=dtype, device=DEV)
    x0s = torch.tensor(0.5 * rng.normal(size=(Bk, 2)), **kw)
    us = torch.tensor(0.2 * rng.normal(size=(Bk, Tk, 1)), **kw)
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
    if reject_every is not None:
        bad = (torch.arange(Bk, device=DEV) % reject_every == 0)[:, None, None]
        k, K = torch.where(bad, 1e3, k), torch.where(bad[..., None], 0.0, K)
    return problem, (xs, us, k.contiguous(), K.contiguous(), val, jac, mu)


def linesearch_vs_plain(name, problem, state, n_cand, bar, min_same_step, rejected=None):
    """Run the line-search kernel and its plain version on the same card
    tensors; raise unless at least ``min_same_step`` of the lanes chose the
    same step and, on those, xs and us agree within ``bar`` of the array's
    largest entry; the lanes of the mask ``rejected`` must take step 0 and get
    their inputs back bit for bit.  Returns (max abs error, share of lanes
    with equal step)."""
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
        check(g.shape == r.shape and g.is_contiguous(), f"{name}: {label} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {label}")
        e = float((g - r)[same].abs().max())
        check(e <= bar * max(1.0, float(r.abs().max())), f"{name}: {label} max err {e:.3e}")
        err = max(err, e)
    extra = {}
    if rejected is not None:
        check(float(got[2][rejected].abs().max()) == 0.0, f"{name}: a rejecting lane took a step")
        check(torch.equal(got[0][rejected], state[0][rejected])
              and torch.equal(got[1][rejected], state[1][rejected]),
              f"{name}: a rejecting lane's incumbent did not come back bit for bit")  # fmt: skip
        extra = dict(rejecting_lanes_bit_exact=int(rejected.sum()))
    steps = sorted({float(v) for v in got[2]})
    say("kernel", case=name, max_abs_err=f"{err:.3e}", bar_rel=bar, lanes_same_step=share,
        min_same_step=min_same_step, steps=steps,
        rejected_lanes=int((got[2] == 0).sum()), **extra)  # fmt: skip
    return err, share


def linesearch_checks():
    """Kernel #4 against its plain version at B=4096, T=32 (and T=200).
    Returns the f32 inputs and error for the timing phase."""
    f64 = torch.float64
    for n_cand in (4, 7, 31, 1):
        linesearch_vs_plain(f"linesearch_f64_B{B}_T{T}_C{n_cand}",
                            *linesearch_inputs(B, f64), n_cand, 1e-10, 1.0)  # fmt: skip
    p32, s32 = linesearch_inputs(B, torch.float32)
    # float32: sinf and the fused multiply-adds of the kernel are not bit-equal
    # to the plain version's, so a lane whose two costs tie may take another
    # rung of the ladder; the lanes that chose the same step must agree
    err32, _ = linesearch_vs_plain(f"linesearch_f32_B{B}_T{T}_C4", p32, s32, 4, 2e-5, 0.99)
    linesearch_vs_plain(f"linesearch_e0_f64_B{B}_T{T}_C4",
                        *linesearch_inputs(B, f64, constrained=False), 4, 1e-10, 1.0)  # fmt: skip
    linesearch_vs_plain("linesearch_ragged_f64_B1000_C4",
                        *linesearch_inputs(1000, f64), 4, 1e-10, 1.0)  # fmt: skip
    # bench.py's pendulum T200 row: the shared-memory plan at a long horizon
    linesearch_vs_plain(f"linesearch_f64_B{B}_T200_C4",
                        *linesearch_inputs(B, f64, Tk=200), 4, 1e-10, 1.0)  # fmt: skip
    # rejecting and accepting lanes inside every block
    linesearch_vs_plain(f"linesearch_mixed_f64_B{B}_T{T}_C4",
                        *linesearch_inputs(B, f64, reject_every=7), 4, 1e-10, 1.0,
                        rejected=torch.arange(B, device=DEV) % 7 == 0)  # fmt: skip
    for dtype in (f64, torch.float32):
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


def resolution_bars(bar, reference, x0s, distances):
    """Bars for a result that the type may not resolve to ``bar``: the
    reference ``reference(x0s)`` solved again from x0s changed by 1e-15 of
    themselves, and each of ``distances(that result)`` (a dict of scaled
    distances to the reference's own result) widened to 10×, never below
    ``bar``.  Returns (the bars, the distances the nudge moved)."""
    moved = distances(reference(x0s * (1 + 1e-15)))
    return {k: max(bar, 10 * v) for k, v in moved.items()}, moved


def flat_solve_vs_plain(name, dtype, Bk, constrained=True, bad_lane=None, spec=None, params=HEADLINE,
                        resolution=False, x0s=None, wide=None, program=None):
    """Run the whole-solve kernel and its plain version on the headline
    problem (or its unconstrained twin, from random controls) at the same
    inputs.  float64: every field within 1e-9 of its array's largest entry
    (opt_lag, a residual of terms the size of the controls, of the largest
    |u|), identical μ and reg.  float32: the share of lanes agreeing on us by
    ``lane_agreement`` ≥ 0.99 and feasible shares within 0.005.
    ``bad_lane`` starts that lane at a NaN state: it must keep its controls
    and escalate its reg while the others are held to the bars above.
    ``spec``: that problem from zero controls instead, solved with
    ``params``.  ``resolution`` (phase 16) holds the kernel to what the type
    resolves on these inputs where the bars above are below it:

    - float64: opt_lag too of its own largest entry, and a field past 1e-9
      within 10× the plain version's own response to a 1e-15 relative
      change of x0 (on the CPU that change moves the RK4 tracking twin's xs
      by 1.4e-8 and fb_k by 1.4e-6 of their scales at T = 32, and the state
      targets' opt_lag, ~1e6 with multipliers to 3e8, by 1e-6 of the
      largest |u|);
    - float32: where fewer than 99% of the lanes agree, against the plain
      float64 version at least the plain f32 version's share of lanes
      within 1e-3 of their scale less 0.02, and the worst lane within
      FD_F32_VS_PLAIN times the plain f32 version's (the state targets at
      T = 32 take μ to 1e9, and there the plain f32 version leaves 62-70%
      of lanes more than 1e-3 from float64 on the CPU); ``wide``: the plain
      float64 result at these starts, where the caller has it.

    ``x0s``: these initial states instead of the headline's first ``Bk``.
    ``program`` ("resident" or "streamed"): that program of the kernel
    instead of the one its launch plan picks.  Prints the launch plan.
    Returns (the largest abs error on us, the plain version's seconds, the
    plain version's result)."""
    given = spec is not None
    if not given:
        spec = SPEC if constrained else dict(SPEC, target=None)
    problem = problem_from_numpy(spec, device=DEV, dtype=dtype)
    x0s = (headline_x0s(dtype)[:Bk] if x0s is None else x0s).clone()
    us0 = None
    if not constrained and not given:
        rng = np.random.default_rng(11)
        us0 = torch.tensor(0.5 * rng.normal(size=(Bk, T, 1)), dtype=dtype, device=DEV)
    lanes = torch.ones(Bk, dtype=torch.bool, device=DEV)
    if bad_lane is not None:
        x0s[bad_lane, 0] = float("nan")
        lanes[bad_lane] = False
    kw = dict(us_init=us0, n_linesearch=HEADLINE_KW["n_linesearch"])
    before = fs.LAUNCHES
    plan = fs.plan_launch(problem, params, x0s, _program=program, **kw)
    got = fs.launch_plan(plan)
    torch.cuda.synchronize()
    check(fs.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel")
    check(program is None or plan.geometry["program"] == program, f"{name}: plan {plan.geometry}")
    t0 = time.perf_counter()
    ref = fs.solve_flat_reference(problem, params, x0s, **kw)
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
        check(torch.equal(got.reg[bad_lane], ref.reg[bad_lane]) and torch.equal(got.mu[bad_lane], ref.mu[bad_lane]),
              f"{name}: the bad lane's reg or mu")  # fmt: skip
        for label, g, r in fields:  # a lane that went NaN stays NaN where the plain version's does
            check(torch.equal(g[bad_lane].isnan(), r[bad_lane].isnan()), f"{name}: the bad lane's NaNs in {label}")
    us_err = float((got.us - ref.us)[lanes].abs().max())
    feas = [float((r.opt_constr[lanes] < 1e-2).float().mean()) for r in (got, ref)]
    out = dict(us_max_err=f"{us_err:.3e}", feasible_kernel=feas[0], feasible_plain=feas[1],
               plain_s=f"{plain_s:.2f}", plan=plan.geometry)  # fmt: skip
    if dtype == torch.float64:
        u_scale = max(1.0, float(ref.us[lanes].abs().max()))

        def rel_errs(res):
            out_ = {}
            for label, _, r in fields:
                if r.numel():
                    own = max(1.0, float(r[lanes].abs().max()))
                    scale = u_scale if label == "opt_lag" and not resolution else own
                    out_[label] = float((attrgetter(label)(res) - r)[lanes].abs().max()) / scale
            return out_

        errs = rel_errs(got)
        bars = dict.fromkeys(errs, 1e-9)
        if resolution and max(errs.values()) > 1e-9:
            bars, moved = resolution_bars(1e-9, lambda x: fs.solve_flat_reference(problem, params, x, **kw),
                                          x0s, rel_errs)  # fmt: skip
            out.update(f64_resolves={k: f"{v:.1e}" for k, v in moved.items() if v > 1e-10})
        for label, rel in errs.items():
            check(rel <= bars[label], f"{name}: {label} differs by {rel:.3e} of its scale, bar {bars[label]:.1e}")
        worst = max(errs.values(), default=0.0)
        check(torch.equal(got.mu[lanes], ref.mu[lanes]), f"{name}: per-lane mu differs")
        check(torch.equal(got.reg[lanes], ref.reg[lanes]), f"{name}: per-lane reg differs")
        out.update(worst_rel_err=f"{worst:.3e}", bar_rel=1e-9, mu_identical=True,
                   reg_identical=True, mu_levels=sorted({float(v) for v in got.mu[lanes]}))  # fmt: skip
    else:
        sel_got = got._replace(us=got.us[lanes])
        agree, worst = lane_agreement(sel_got, ref._replace(us=ref.us[lanes]))
        check(abs(feas[0] - feas[1]) <= 0.005, f"{name}: feasible shares {feas}")
        out.update(lanes_us_agree=agree, us_max_scaled_err=f"{worst:.3e}",
                   mu_equal=float((got.mu == ref.mu)[lanes].float().mean()))  # fmt: skip
        if agree < 0.99 and resolution:
            # float32 does not resolve the controls here: the plain version
            # itself leaves most lanes more than 1e-3 of their scale from
            # float64, so the kernel is held to float64 as closely as it is
            if wide is None:
                wide = fs.solve_flat_reference(problem_from_numpy(spec, device=DEV, dtype=torch.float64),
                                               params, x0s.double(), **kw)  # fmt: skip
            wide = wide._replace(us=wide.us[lanes].float())
            k_agree, k_worst = lane_agreement(sel_got, wide)
            p_agree, p_worst = lane_agreement(ref._replace(us=ref.us[lanes]), wide)
            check(k_agree >= p_agree - 0.02 and k_worst <= FD_F32_VS_PLAIN * p_worst,
                  f"{name}: against f64 {k_agree} of lanes (worst {k_worst:.3e}), the plain f32 "
                  f"version {p_agree} ({p_worst:.3e})")  # fmt: skip
            out.update(lanes_agree_f64_kernel=k_agree, lanes_agree_f64_plain=p_agree,
                       worst_f64_kernel=f"{k_worst:.3e}", worst_f64_plain=f"{p_worst:.3e}")  # fmt: skip
        else:
            check(agree >= 0.99, f"{name}: only {agree} of lanes agree on us to 1e-3 of their scale")
    say("kernel", case=name, **out)
    return us_err, plain_s, ref


def flat_solve_checks():
    """Kernel #5 against its plain version on the headline problem, the plain
    version once per case.  Returns the f32 error on us and the f32 plain
    version's seconds at B=4096."""
    flat_solve_vs_plain(f"flat_solve_f64_B{B}_T{T}", torch.float64, B)
    err32, plain_s, _ = flat_solve_vs_plain(f"flat_solve_f32_B{B}_T{T}", torch.float32, B)
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


def tf32_guard_parity(problem, res):
    """The stages ``al.full_fp32_matmuls`` pins (the sweep backward, the
    optimality adjoints, update_origin, the sweep and seq line searches on
    the sweep's gains) must give the same bits with TF32 allowed around them
    as with it off, on the arm's finished solve.  Also
    reports whether the same stages without the guard change under TF32 at
    all (cuBLAS may take a non-tensor-core kernel for such small products,
    and then the guard has nothing to undo at these shapes)."""
    derivs = problem.derivatives(res.xs, res.us)
    mults, mu, reg = res.mults, res.mu, res.reg

    def stages(unwrap=lambda f: f):
        k, K, ok = unwrap(_backward_sweep)(derivs, mults.val, mults.jac, mu, reg)
        ls = (problem, res.xs, res.us, k, K, mults, mu, ARM_KW["n_linesearch"])
        return (
            k, K, ok,
            unwrap(al._adjoint_scores)(derivs, mults.val, mults.jac, mu),
            *unwrap(al.update_origin)(problem.model, mults, res.xs),
            *unwrap(_linesearch_sweep)(*ls),
            *unwrap(_linesearch_seq)(*ls),
        )  # fmt: skip

    def same(xs, ys):  # NaN where both are
        return all(a.shape == b.shape and bool(((a == b) | (a != a) & (b != b)).all())
                   for a, b in zip(xs, ys))  # fmt: skip

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        full = stages()
        torch.backends.cuda.matmul.allow_tf32 = True
        guarded = stages()
        unguarded = stages(lambda f: f.__wrapped__)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    check(same(full, guarded), "a pinned stage changed with TF32 allowed around it")
    return dict(pinned_stages_bit_exact=True, unguarded_stages_change_under_tf32=not same(full, unguarded))


def arm_main_path():
    """Phase 5: the fleet row through both kernels, its checks, and the
    jvp/sweep and f64 comparisons.  Returns ((riccati launches, levels swept), fd launches,
    problem, x0s, us0, and the four results: f32 kernel, f32 jvp/sweep, f64
    kernel at 6 iterations, with its inputs)."""
    p32, x32, u32 = arm_problem(torch.float32)
    reset_launch_counts()
    walls, peak_mb = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_k = arm_solve(p32, x32, u32, "kernel", "kernel")
    walls["kernel"] = time.perf_counter() - t0
    peak_mb["kernel"] = torch.cuda.max_memory_allocated() / 2**20
    rs_launches, fd_launches, rs_levels = rs.LAUNCHES, fd.LAUNCHES, rs.LEVELS_SWEPT
    # one derivative pass before the loop, one per iteration, one for the
    # final optimality; one backward pass before the loop and one per
    # iteration, each one launch for the whole regularization ladder
    fd_expected = 1 + ARM.max_iterations + 1
    rs_expected = 1 + ARM.max_iterations
    check(fd_launches == fd_expected, f"fd launches {fd_launches} != {fd_expected}")
    check(rs_launches == rs_expected, f"riccati launches {rs_launches} != {rs_expected}")
    check(rs_levels == rs_expected * ARM_REG_LEVELS, f"riccati levels swept {rs_levels}")
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"arm: non-finite {name}")
    check(res_k.us.shape == (ARM_B, ARM_H, 7) and res_k.xs.shape == (ARM_B, ARM_H + 1, 14),
          "arm: result shapes")  # fmt: skip
    frac_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(frac_k >= 0.90, f"arm f32 frac_main {frac_k}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res_j = arm_solve(p32, x32, u32, "jvp", "sweep")
    walls["jvp"] = time.perf_counter() - t0
    peak_mb["jvp"] = torch.cuda.max_memory_allocated() / 2**20
    frac_j = float((res_j.opt_constr < 1e-2).float().mean())
    check(abs(frac_k - frac_j) <= 0.02, f"arm feasible shares {frac_k} vs {frac_j}")
    # TF32 allowed for the solve (the gate-critical stages and the line
    # search stay in full float32 whatever the setting)
    res_h = solve_batched(p32, ARM, x32, us_init=u32, deriv="kernel", backward="kernel",
                          **dict(ARM_KW, matmul_precision="high"))  # fmt: skip
    torch.cuda.synchronize()
    frac_h = float((res_h.opt_constr < 1e-2).float().mean())
    check(bool(torch.isfinite(res_h.us).all()), "arm f32 under matmul_precision='high': non-finite us")
    check(abs(frac_h - frac_k) <= 0.02, f"arm frac_main under 'high' {frac_h} vs 'highest' {frac_k}")
    guard = tf32_guard_parity(p32, res_k)
    say("arm_f32_matmul_precision", frac_main_highest=frac_k, frac_main_high=frac_h, bar=0.02,
        us_max_diff=f"{float((res_h.us - res_k.us).abs().max()):.3e}",
        mu_equal=float((res_h.mu == res_k.mu).float().mean()), **guard)  # fmt: skip
    say("arm_f32", B=ARM_B, H=ARM_H, iters=ARM.max_iterations, fd_launches=fd_launches,
        riccati_launches=rs_launches, riccati_levels_swept=rs_levels,
        frac_main_kernel=frac_k, frac_main_jvp_sweep=frac_j,
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
    return (rs_launches, rs_levels), fd_launches, p32, x32, u32, res_k, res_j, (r64_k, x64, u64), (walls, peak_mb)


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
    rs.LAUNCHES = rs.LAUNCHES_SECOND_ORDER = rs.LEVELS_SWEPT = fd.LAUNCHES = fd2.LAUNCHES = 0
    lsf.LAUNCHES = fs.LAUNCHES = 0


def launch_counts():
    return dict(riccati=rs.LAUNCHES, fd=fd.LAUNCHES, fd2=fd2.LAUNCHES,
                linesearch=lsf.LAUNCHES, flat_solve=fs.LAUNCHES)  # fmt: skip


def check_finite(res, what):
    """Everything a caller uses of a full-DDP result is finite.  ``opt_lag``
    is left out and counted instead: the recipe caps neither μ nor the
    iteration count, so after 24 + 4 iterations in f32 μ has reached 1e16 to
    1e28 and the multipliers 1e12 to 1e21 on lanes that are feasible (the
    same schedule in ddp_tpu).  The measure's norm is scaled where its plain
    sum of squares overflows (``al._adjoint_scores``), so a lane counted here
    overflowed inside the adjoint recursion.  Returns the number of lanes
    whose ``opt_lag`` is not finite."""
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "mu", "reg", "w", "n"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"{what}: non-finite {name}")
    check(bool(torch.isfinite(res.mults.val).all()), f"{what}: non-finite multipliers")
    return int((~torch.isfinite(res.opt_lag)).sum())


def arm_second_order_path(x32, u32, gn_k, gn_j, gn64):
    """Phase 6: the Gauss-Newton results of phase 5 warm-start the full-DDP
    polish through both new kernels; a cold full-DDP solve; the jvp/sweep
    and f64 comparisons.  Returns (fd2 launches, (second-order Riccati
    launches, levels swept), the second_order problem, the shares and wall
    times)."""
    p2, _, _ = arm_problem(torch.float32, second_order=True)
    frac_gn = float((gn_k.opt_constr < 1e-2).float().mean())
    reset_launch_counts()
    t0 = time.perf_counter()
    res_k = ddp_stage(p2, x32, gn_k, "kernel", "kernel")
    wall_k = time.perf_counter() - t0
    fd2_launches, rs2_launches, rs2_levels = fd2.LAUNCHES, rs.LAUNCHES_SECOND_ORDER, rs.LEVELS_SWEPT
    # one derivative pass before the loop, one per iteration, one for the
    # final optimality; a backward pass before the loop and one per
    # iteration, each one launch for the whole regularization ladder
    fd2_expected = 1 + DDP.max_iterations + 1
    rs2_expected = 1 + DDP.max_iterations
    check(fd2_launches == fd2_expected, f"fd2 launches {fd2_launches} != {fd2_expected}")
    check(rs2_launches == rs2_expected, f"2nd-order riccati launches {rs2_launches} != {rs2_expected}")
    check(rs2_levels == rs2_expected * ARM_REG_LEVELS, f"2nd-order riccati levels swept {rs2_levels}")
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
        riccati2_launches=rs2_launches, riccati2_levels_swept=rs2_levels, frac_gn_stage=frac_gn, frac_chain_kernel=frac_k,
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
    check(cold_rs2 == 1 + DDP_COLD.max_iterations, f"cold 2nd-order riccati launches {cold_rs2}")
    check(rs.LEVELS_SWEPT == cold_rs2 * ARM_REG_LEVELS, f"cold levels swept {rs.LEVELS_SWEPT}")
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
    return fd2_launches, (rs2_launches, rs2_levels), p2, dict(
        frac_gn=frac_gn, frac_chain=frac_k, frac_cold=frac_cold, wall_jvp_sweep=wall_j
    )


# ----------------------------------------------------- quadrotor and solve


def model_leaves(model):
    """``convert.robot_model_from_numpy``'s leaves of a port RobotModel."""
    leaves = {k: None if getattr(model, k) is None else getattr(model, k).cpu().numpy()
              for k in ("jp_rot", "jp_trans", "axes", "inertias", "gravity", "frame_rot",
                        "frame_trans", "damping", "q_lower", "q_upper", "v_limit", "tau_limit")}  # fmt: skip
    leaves.update({k: getattr(model, k) for k in ("joint_types", "parents", "frame_bodies",
                                                   "frame_names", "name")})  # fmt: skip
    return leaves


def quadrotor_spec(horizon):
    """bench.py's quadrotor row as ``convert.problem_from_numpy``'s numpy
    spec: the freeflyer (``robots.quadrotor``'s leaves), Euler dt = 0.02,
    ½‖u‖², a StateTarget at q0 ⊕ (0.3, −0.2, 0.4, 0, 0, 0.2) at rest two
    steps past the horizon, Gauss-Newton.  The goal is integrated in f64 on
    the CPU."""
    quad = robots.quadrotor(device="cpu", dtype=torch.float64)
    q_goal = quad.integrate(quad.neutral_configuration(),
                            torch.tensor([0.3, -0.2, 0.4, 0.0, 0.0, 0.2], dtype=torch.float64))  # fmt: skip
    target = np.concatenate([q_goal.numpy(), np.zeros(6)])
    return dict(
        robot=model_leaves(quad), dt=0.02, c=1.0, horizon=horizon, second_order=False,
        constraint=dict(kind="state", target=target, active_ts=(horizon,), advance_times=2),
    )  # fmt: skip


def quadrotor_row(dtype, Bk=None):
    """The row's problem on the card and its inputs: x0s = x0 ⊕ 0.05·N(0, 1)
    (the draws of ``default_rng(0)``, rounded to float32 as bench.py's),
    us0 = the gravity compensation rnea(q, 0, 0) tiled over the horizon."""
    Bk = QUAD_B if Bk is None else Bk
    problem = problem_from_numpy(quadrotor_spec(QUAD_H), device=DEV, dtype=dtype)
    quad = problem.model
    kw = dict(dtype=dtype, device=DEV)
    rng = np.random.default_rng(0)
    dxs = torch.tensor(0.05 * rng.standard_normal((QUAD_B, 12)).astype(np.float32)[:Bk], **kw)
    x0 = state_pack(quad.neutral_configuration(), torch.zeros(6, **kw))
    x0s = state_integrate(quad, x0.expand(Bk, -1), dxs)
    zero_v = torch.zeros(6, **kw)
    us0 = quad.rnea(x0s[:, :7], zero_v, zero_v)[:, None, :].repeat(1, QUAD_H, 1)
    return problem, x0s, us0


def quad_solve(problem, x0s, us0, backward, params=QUAD):
    res = solve_batched(problem, params, x0s, us_init=us0, backward=backward, **QUAD_KW)
    torch.cuda.synchronize()
    return res


def quadrotor_path():
    """Phase 7: the quadrotor row through the Riccati kernel at (12, 6, 12)
    and through the sweep, its checks, and both in f64 at 16 lanes (``QUAD64``).  Returns
    the kernel route's (launches, levels swept), and the two routes' shares
    and wall times (one solve each, the row's times)."""
    p32, x32, u32 = quadrotor_row(torch.float32)
    reset_launch_counts()
    t0 = time.perf_counter()
    res_k = quad_solve(p32, x32, u32, "kernel")
    wall_k = time.perf_counter() - t0
    counts, levels = launch_counts(), rs.LEVELS_SWEPT
    # one backward call before the loop and one per iteration, each one launch
    # for the whole ladder; no other kernel
    expected = dict(riccati=1 + QUAD.max_iterations, fd=0, fd2=0, linesearch=0, flat_solve=0)
    check(counts == expected, f"quadrotor launches {counts} != {expected}")
    check(levels == expected["riccati"] * QUAD_REG_LEVELS, f"quadrotor levels swept {levels}")
    for name in RESULT_FIELDS:
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"quadrotor: non-finite {name}")
    check(res_k.us.shape == (QUAD_B, QUAD_H, 6) and res_k.xs.shape == (QUAD_B, QUAD_H + 1, 13),
          "quadrotor: result shapes")  # fmt: skip
    qn = torch.linalg.vector_norm(res_k.xs[:, -1, 3:7].double(), dim=-1)
    qn_err = float((qn - 1).abs().max())
    check(qn_err <= 1e-5, f"quadrotor terminal quaternion norms off by {qn_err}")
    frac_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(frac_k >= QUAD_JAX_CPU_SHARE - 0.01,
          f"quadrotor feasible share {frac_k} below ddp_tpu's {QUAD_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    t0 = time.perf_counter()
    res_s = quad_solve(p32, x32, u32, "sweep")
    wall_s = time.perf_counter() - t0
    frac_s = float((res_s.opt_constr < 1e-2).float().mean())
    check(abs(frac_k - frac_s) <= 0.01, f"quadrotor feasible shares {frac_k} vs {frac_s}")
    check(bool(torch.isfinite(res_s.us).all()), "quadrotor sweep: non-finite us")
    agree, worst = lane_agreement(res_k, res_s)
    say("quadrotor_f32", B=QUAD_B, H=QUAD_H, iters=QUAD.max_iterations, launches=counts,
        levels_swept=levels, frac_kernel=frac_k, frac_sweep=frac_s,
        frac_ddp_tpu_cpu=QUAD_JAX_CPU_SHARE,
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}",
        quat_norm_max_err=f"{qn_err:.3e}", lanes_us_agree=agree, us_max_scaled_err=f"{worst:.3e}",
        mu_equal=float((res_k.mu == res_s.mu).float().mean()),
        first_solve_s_kernel=f"{wall_k:.3f}", solve_s_sweep=f"{wall_s:.3f}")  # fmt: skip

    p64, x64, u64 = quadrotor_row(torch.float64, QUAD_B64)
    r64_k = quad_solve(p64, x64, u64, "kernel", QUAD64)
    r64_s = quad_solve(p64, x64, u64, "sweep", QUAD64)
    diff = (r64_k.us - r64_s.us).abs().amax(dim=(1, 2))
    scale = r64_s.us.abs().amax(dim=(1, 2)).clamp(min=1.0)
    err64 = float((diff / scale).max())
    check(err64 <= 1e-7, f"quadrotor f64 us max scaled err {err64}")
    check(torch.equal(r64_k.mu, r64_s.mu), "quadrotor f64 per-lane mu differs")
    say("quadrotor_f64", B=QUAD_B64, iters=QUAD64.max_iterations, us_max_scaled_err=f"{err64:.3e}",
        mu_identical=True, frac_kernel=float((r64_k.opt_constr < 1e-2).float().mean()))  # fmt: skip
    return (counts["riccati"], levels), dict(
        frac_kernel=frac_k, frac_sweep=frac_s, wall_kernel=wall_k, wall_sweep=wall_s
    )


def golden_problem():
    """The reference's pendulum problem (tests/test_reference_parity.py's
    golden configuration): T = 200, a configuration target q = 3.14 two steps
    past the horizon, ½‖u‖², full DDP, f64, on the card."""
    spec = dict(mass=1.0, length=1.0, dt=0.01, c=1.0, target=np.array([3.14]),
                active_ts=(200,), advance_times=2, horizon=200, second_order=True)  # fmt: skip
    return problem_from_numpy(spec, device=DEV, dtype=torch.float64)


def solve_path():
    """Phase 8: ``ddp_tpu_torch.solve`` on CUDA tensors — the golden file's
    configuration against its committed controls (max|Δu| < 1e-9,
    max|Δx| < 1e-11, converged in ≤ 200 iterations) and
    tests/test_model_zoo.py's quadrotor solve (f64, H = 24, opt_constr <
    1e-3).  Returns the wall times."""
    golden = np.load(GOLDEN)
    problem = golden_problem()
    t0 = time.perf_counter()
    res = ddp_solve(problem, SolverParams(200, 1e-9, mu=1e8), torch.zeros(2, dtype=torch.float64, device=DEV))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(res.us.device.type == "cuda", "solve: result not on the card")
    du = float(np.abs(res.us.cpu().numpy() - golden["us"]).max())
    dx = float(np.abs(res.xs.cpu().numpy() - golden["xs"]).max())
    iters = int(res.stats.iterations)
    check(bool(res.stats.converged) and iters <= 200, f"solve: not converged in 200 iterations ({iters})")
    check(du < 1e-9 and dx < 1e-11, f"solve: golden max|du| {du:.3e}, max|dx| {dx:.3e}")
    say("solve_golden", T=200, iters=iters, max_du=f"{du:.3e}", max_dx=f"{dx:.3e}",
        opt_lag=f"{float(res.stats.opt_lag):.3e}", opt_constr=f"{float(res.stats.opt_constr):.3e}",
        wall_s=f"{wall:.3f}", s_per_iteration=f"{wall / iters:.4f}")  # fmt: skip

    H = 24
    quad = problem_from_numpy(quadrotor_spec(H), device=DEV, dtype=torch.float64)
    m = quad.model
    kw = dict(dtype=torch.float64, device=DEV)
    q0, zero_v = m.neutral_configuration(), torch.zeros(6, **kw)
    us0 = m.rnea(q0, zero_v, zero_v)[None].repeat(H, 1)
    t0 = time.perf_counter()
    rq = ddp_solve(quad, SolverParams(40, 1e-8, mu=1e4, inner_iters_max=3), torch.cat([q0, zero_v]),
                   us_init=us0)  # fmt: skip
    torch.cuda.synchronize()
    wall_q = time.perf_counter() - t0
    oc = float(rq.stats.opt_constr)
    check(bool(torch.isfinite(rq.us).all()) and oc < 1e-3, f"quadrotor solve: opt_constr {oc}")
    say("solve_quadrotor", H=H, iters=int(rq.stats.iterations), opt_constr=f"{oc:.3e}",
        wall_s=f"{wall_q:.3f}")  # fmt: skip
    return dict(golden_s=wall, golden_iters=iters, quadrotor_s=wall_q)


# ------------------------------------------------------- UR5 chain and MPC


def ur5_problem(dtype, second_order=False):
    """benchmarks/arm_second_order.py's problem (bench.py's MPC replan's at
    second_order=False): Euler UR5 (dt = 0.01), ½‖u‖², the configuration
    q0 ⊕ 0.05·(1 … 6) at H = 16, advanced twice."""
    kw = dict(dtype=dtype, device=DEV)
    arm = robots.ur5(**kw)
    dyn = dynamics.euler(arm, 0.01)
    q_target = arm.integrate(arm.neutral_configuration(), torch.tensor(0.05 * np.arange(1.0, 7.0), **kw))
    con = constraints.advance_time(constraints.ConfigTarget(arm, q_target, (UR5_H,)), dyn, times=2)
    return Problem(dyn, costs.quad_control(1.0, **kw), con, UR5_H, second_order=second_order)


def ur5_x0s(dtype, Bk):
    """x0 = neutral at rest + 0.1·N(0, 1) from default_rng(0), the first
    ``Bk`` of the chain's 512 draws."""
    rng = np.random.default_rng(0)
    return torch.tensor(0.1 * rng.standard_normal((UR5_B, 12))[:Bk], dtype=dtype, device=DEV)


def ur5_chain(dtype, Bk, deriv, backward):
    """The Gauss-Newton stage, then the full-DDP stage warm-started on its
    (us, mults, μ, reg, w, n).  Returns ((stage results), (launch counts
    and levels swept of each stage), (wall seconds of each stage))."""
    x0s = ur5_x0s(dtype, Bk)
    kw = dict(deriv=deriv, backward=backward, **UR5_KW)
    out, counts, walls = [], [], []
    for problem, params, warm in (
        (ur5_problem(dtype), UR5_GN, None),
        (ur5_problem(dtype, second_order=True), UR5_DDP, True),
    ):  # fmt: skip
        if warm:
            r1 = out[0]
            kw.update(us_init=r1.us, mults_init=r1.mults, mu_init=r1.mu, reg_init=r1.reg,
                      w_init=r1.w, n_init=r1.n)  # fmt: skip
        reset_launch_counts()
        t0 = time.perf_counter()
        out.append(solve_batched(problem, params, x0s, **kw))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(dict(launch_counts(), riccati_second_order=rs.LAUNCHES_SECOND_ORDER,
                           levels_swept=rs.LEVELS_SWEPT))  # fmt: skip
    return tuple(out), tuple(counts), tuple(walls)


def lane_scaled_err(a, b):
    """max over lanes of max_t |Δu| / max(1, max_t |u|)."""
    diff = (a.us - b.us).abs().amax(dim=(1, 2))
    return float((diff / b.us.abs().amax(dim=(1, 2)).clamp(min=1.0)).max())


def ur5_chain_path():
    """Phase 9: benchmarks/arm_second_order.py's UR5 chain at full size
    through kernels #2 and #1 (Gauss-Newton stage) and #3 and #1 with the
    second-order terms (full-DDP stage), each stage's launches exactly; the
    feasible shares against ddp_tpu's on the CPU; the same chain through
    jvp/sweep, and both routes in f64 at 16 lanes."""
    (gn, dd), (c_gn, c_dd), (w_gn, w_dd) = ur5_chain(torch.float32, UR5_B, "kernel", "kernel")
    # a derivative pass before the loop, one per iteration and one for the
    # final optimality; a backward call before the loop and one per
    # iteration, each one launch for the whole ladder
    expect_gn = dict(riccati=1 + UR5_GN.max_iterations, fd=2 + UR5_GN.max_iterations, fd2=0,
                     linesearch=0, flat_solve=0, riccati_second_order=0,
                     levels_swept=(1 + UR5_GN.max_iterations) * UR5_REG_LEVELS)  # fmt: skip
    n_dd = 1 + UR5_DDP.max_iterations
    expect_dd = dict(riccati=n_dd, fd=0, fd2=2 + UR5_DDP.max_iterations, linesearch=0,
                     flat_solve=0, riccati_second_order=n_dd, levels_swept=n_dd * UR5_REG_LEVELS)  # fmt: skip
    check(c_gn == expect_gn, f"UR5 Gauss-Newton stage launches {c_gn} != {expect_gn}")
    check(c_dd == expect_dd, f"UR5 full-DDP stage launches {c_dd} != {expect_dd}")
    overflow = [check_finite(r, f"UR5 {what}") for r, what in ((gn, "GN stage"), (dd, "chain"))]
    check(dd.us.shape == (UR5_B, UR5_H, 6) and dd.xs.shape == (UR5_B, UR5_H + 1, 12), "UR5 shapes")
    frac_gn = float((gn.opt_constr < 1e-2).float().mean())
    frac = float((dd.opt_constr < 1e-2).float().mean())
    check(frac_gn >= UR5_JAX_CPU_SHARE - 0.01,
          f"UR5 GN share {frac_gn} below ddp_tpu's {UR5_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    check(frac >= frac_gn - 0.01, f"UR5 chain share {frac} vs its GN stage's {frac_gn}")
    (gn_j, dd_j), c_j, (wj_gn, wj_dd) = ur5_chain(torch.float32, UR5_B, "jvp", "sweep")
    check(all(sum(v for k, v in c.items() if k != "levels_swept") == 0 for c in c_j),
          f"a kernel ran on the jvp/sweep route: {c_j}")  # fmt: skip
    check_finite(dd_j, "UR5 chain jvp/sweep")
    frac_gn_j = float((gn_j.opt_constr < 1e-2).float().mean())
    frac_j = float((dd_j.opt_constr < 1e-2).float().mean())
    check(abs(frac_gn - frac_gn_j) <= 0.02 and abs(frac - frac_j) <= 0.02,
          f"UR5 routes' shares: GN {frac_gn} vs {frac_gn_j}, chain {frac} vs {frac_j}")  # fmt: skip
    say("ur5_chain_f32", B=UR5_B, H=UR5_H, gn_iters=UR5_GN.max_iterations,
        ddp_iters=UR5_DDP.max_iterations, launches_gn=c_gn, launches_ddp=c_dd,
        frac_gn=frac_gn, frac_chain=frac, frac_gn_jvp_sweep=frac_gn_j,
        frac_chain_jvp_sweep=frac_j, frac_ddp_tpu_cpu_gn=UR5_JAX_CPU_SHARE,
        p99_eq_gn=f"{float(torch.quantile(gn.opt_constr, 0.99)):.3e}",
        p99_eq_chain=f"{float(torch.quantile(dd.opt_constr, 0.99)):.3e}",
        opt_lag_overflow_lanes=overflow, mu_max=f"{float(dd.mu.max()):.1e}",
        us_moved=f"{float((dd.us - gn.us).abs().max()):.3e}",
        us_max_scaled_err_routes=f"{lane_scaled_err(dd, dd_j):.3e}",
        mu_equal=float((dd.mu == dd_j.mu).float().mean()),
        stage_s_kernel=[f"{w_gn:.3f}", f"{w_dd:.3f}"], stage_s_jvp_sweep=[f"{wj_gn:.3f}", f"{wj_dd:.3f}"])  # fmt: skip

    (g64_k, d64_k), _, _ = ur5_chain(torch.float64, UR5_B64, "kernel", "kernel")
    (g64_j, d64_j), _, _ = ur5_chain(torch.float64, UR5_B64, "jvp", "sweep")
    errs = []
    for a, b, stage in ((g64_k, g64_j, "GN stage"), (d64_k, d64_j, "chain")):
        errs.append(lane_scaled_err(a, b))
        check(errs[-1] <= 1e-7, f"UR5 f64 {stage}: us max scaled err {errs[-1]}")
        check(torch.equal(a.mu, b.mu), f"UR5 f64 {stage}: per-lane mu differs")
    say("ur5_chain_f64", B=UR5_B64, us_max_scaled_err=[f"{e:.3e}" for e in errs], mu_identical=True,
        frac_chain=float((d64_k.opt_constr < 1e-2).float().mean()))  # fmt: skip
    return dict(launches_gn=c_gn, launches_ddp=c_dd, frac_gn=frac_gn, frac_chain=frac,
                frac_gn_jvp_sweep=frac_gn_j, frac_chain_jvp_sweep=frac_j,
                walls_kernel=[w_gn + w_dd], walls_jvp_sweep=[wj_gn + wj_dd])  # fmt: skip


def replans(step, x, carry, n, timed=False):
    """``n`` replans of ``step`` from the measured state ``x`` (held, as
    bench.py's replans are), the carry carried.  Returns the outputs, and
    with ``timed`` each replan's synchronized wall seconds and launches."""
    outs, walls, counts = [], [], []
    for _ in range(n):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = step(x, carry)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(dict(launch_counts(), levels_swept=rs.LEVELS_SWEPT))
        outs.append(out)
        carry = out.carry
    return (outs, walls, counts) if timed else outs


def carry_leaves(carry):
    return [x for a in carry if a is not None for x in (a if isinstance(a, tuple) else (a,))]


def closed_loop(problem, step, x0, n):
    """run_mpc's loop around ``step``: replan, apply u0 to the problem's own
    dynamics.  Returns the states [n + 1, nx]."""
    carry = mpc.init_carry(problem, dtype=x0.dtype, x0=x0)
    x, xs = x0, [x0]
    for t in range(n):
        out = step(x, carry)
        x, carry = problem.dynamics(t, x, out.u0), out.carry
        xs.append(x)
    return torch.stack(xs)


def pendulum_state_problem():
    """test_aux_subsystems.py::test_mpc_receding_horizon's problem on the
    card: the pendulum to [q, v] = [3.14, 0] two steps past H = 30, ½‖u‖²,
    full DDP, f64."""
    spec = dict(mass=1.0, length=1.0, dt=0.01, c=1.0, horizon=PEND_MPC_H, second_order=True,
                constraint=dict(kind="state", target=np.array([3.14, 0.0]),
                                active_ts=(PEND_MPC_H,), advance_times=2))  # fmt: skip
    return problem_from_numpy(spec, device=DEV, dtype=torch.float64)


def ur5_mpc_path():
    """Phase 10: bench.py's UR5 MPC replan through ``make_mpc_step`` on the
    default route (backward="sweep") and through kernel #1 at (12, 6, 6),
    B = 1 (backward="kernel"): a warm-up replan, then ``MPC_REPLANS`` timed replans from
    x0 at rest with the carry carried; launches per replan exactly; u0 and the
    carry finite; both routes in f64 (u0 within 1e-7 of |u0|, identical μ);
    ``run_mpc`` and the closed loop of both routes for ``MPC_LOOP_STEPS`` steps in f64, held
    to the loop's own amplification of one ulp of x0; and
    test_mpc_receding_horizon's pendulum loop through the kernel."""
    out = {}
    for backward in ("sweep", "kernel"):
        problem = ur5_problem(torch.float32)
        step = mpc.make_mpc_step(problem, MPC, backward=backward)
        x0 = state_pack(problem.model.neutral_configuration(), torch.zeros(6, device=DEV))
        warm = replans(step, x0, mpc.init_carry(problem), 1)[-1]  # bench.py's compile call
        outs, walls, counts = replans(step, x0, warm.carry, MPC_REPLANS, timed=True)
        n_bwd = 1 + MPC.max_iterations
        expect = dict(riccati=n_bwd if backward == "kernel" else 0, fd=0, fd2=0, linesearch=0,
                      flat_solve=0, levels_swept=n_bwd * UR5_REG_LEVELS if backward == "kernel" else 0)  # fmt: skip
        check(all(c == expect for c in counts), f"UR5 replan launches ({backward}) {counts[0]} != {expect}")
        for o in outs:
            check(bool(torch.isfinite(o.u0).all() and torch.isfinite(o.K0).all()), f"UR5 replan {backward}: u0")
            check(all(bool(torch.isfinite(x).all()) for x in carry_leaves(o.carry)),
                  f"UR5 replan {backward}: non-finite carry")  # fmt: skip
        ms = 1e3 * np.asarray(walls)
        out[backward] = dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                             launches_per_replan=counts[0], opt_constr_last=float(outs[-1].opt_constr))  # fmt: skip
        say("ur5_mpc_f32", backward=backward, replans=MPC_REPLANS, T=UR5_H,
            iters=MPC.max_iterations, p50_ms=f"{out[backward]['p50_ms']:.2f}",
            p99_ms=f"{out[backward]['p99_ms']:.2f}", min_ms=f"{ms.min():.2f}",
            launches_per_replan=counts[0], opt_constr_first=f"{float(outs[0].opt_constr):.3e}",
            opt_constr_last=f"{float(outs[-1].opt_constr):.3e}",
            mu_last=f"{float(outs[-1].carry.mu):.1e}")  # fmt: skip

    # f64: both routes replan for replan from the same states
    p64 = ur5_problem(torch.float64)
    x0 = state_pack(p64.model.neutral_configuration(), torch.zeros(6, dtype=torch.float64, device=DEV))
    r64 = {b: replans(mpc.make_mpc_step(p64, MPC, backward=b), x0, mpc.init_carry(p64), 6)
           for b in ("sweep", "kernel")}  # fmt: skip
    err = 0.0
    for a, b in zip(r64["kernel"], r64["sweep"]):
        e = float((a.u0 - b.u0).abs().max() / b.u0.abs().max().clamp(min=1.0))
        check(e <= 1e-7, f"UR5 replan f64 u0 routes differ by {e:.3e} of |u0|")
        check(float(a.carry.mu) == float(b.carry.mu), "UR5 replan f64: μ differs between routes")
        err = max(err, e)
    # closed loops: run_mpc (the default route), and make_mpc_step's
    # replans on both routes around the same plant
    xs_run, us_run, _ = mpc.run_mpc(p64, MPC, x0, MPC_LOOP_STEPS)
    torch.cuda.synchronize()
    check(xs_run.shape == (MPC_LOOP_STEPS + 1, 12) and bool(torch.isfinite(xs_run).all()),
          "run_mpc: non-finite states")  # fmt: skip
    # The loop amplifies roundoff: this script's first run on an H100 80GB
    # HBM3 moved the sweep route's states by 3.3e-6 of their scale after 20
    # steps when x0 moved by 1e-15, and the two routes' by 2.5e-7.  So each
    # step's states are held within 1e-7 of the scale or within what one
    # ulp of x0 does to the same route, whichever is larger.
    one_ulp = x0.clone()
    one_ulp[6] += 1e-15
    loops = {b: closed_loop(p64, mpc.make_mpc_step(p64, MPC, backward=b.split("_")[0]), x, MPC_LOOP_STEPS)
             for b, x in (("sweep", x0), ("kernel", x0), ("sweep_1ulp", one_ulp))}  # fmt: skip
    check(all(bool(torch.isfinite(xs).all()) for xs in loops.values()), "UR5 closed loop: non-finite")
    scale = loops["sweep"].abs().max()
    step_err = (loops["kernel"] - loops["sweep"]).abs().amax(dim=1) / scale
    step_ulp = (loops["sweep_1ulp"] - loops["sweep"]).abs().amax(dim=1) / scale
    check(bool((step_err <= torch.clamp(step_ulp, min=1e-7)).all()),
          f"UR5 closed loops' states differ by {step_err.tolist()} of their scale, one ulp of x0 "
          f"by {step_ulp.tolist()}")  # fmt: skip
    say("ur5_mpc_f64", replans=6, u0_max_scaled_err=f"{err:.3e}", mu_identical=True,
        run_mpc_steps=MPC_LOOP_STEPS, closed_loop_state_err=f"{float(step_err.max()):.3e}",
        closed_loop_one_ulp_x0=f"{float(step_ulp.max()):.3e}", state_scale=f"{float(scale):.3e}",
        q_final_run_mpc=[f"{v:.4f}" for v in xs_run[-1, :6].tolist()])  # fmt: skip

    # the pendulum's receding-horizon loop through the kernel (full DDP at
    # (2, 1, 2)), with test_mpc_receding_horizon's bars
    pend = pendulum_state_problem()
    step = mpc.make_mpc_step(pend, PEND_MPC, backward="kernel")
    carry, x = mpc.init_carry(pend), torch.zeros(2, dtype=torch.float64, device=DEV)
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(PEND_MPC_REPLANS):
        o = step(x, carry)
        carry, x = o.carry, pend.dynamics(0, x, o.u0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = PEND_MPC_REPLANS * (1 + PEND_MPC.max_iterations)
    check(rs.LAUNCHES == rs.LAUNCHES_SECOND_ORDER == n_launch,
          f"pendulum MPC launches {rs.LAUNCHES} ({rs.LAUNCHES_SECOND_ORDER} 2nd order) != {n_launch}")  # fmt: skip
    check(bool(torch.isfinite(x).all()), "pendulum MPC: non-finite state")
    check(abs(float(x[0]) - 3.14) < 0.02 and abs(float(x[1])) < 0.1, f"pendulum MPC ended at {x.tolist()}")
    say("pendulum_mpc_f64", backward="kernel", replans=PEND_MPC_REPLANS, launches=n_launch,
        q=f"{float(x[0]):.5f}", v=f"{float(x[1]):.3e}", wall_s=f"{wall:.3f}",
        ms_per_replan=f"{1e3 * wall / PEND_MPC_REPLANS:.2f}")  # fmt: skip
    out["pendulum"] = dict(launches=n_launch, ms_per_replan=1e3 * wall / PEND_MPC_REPLANS)
    return out


# ------------------------------------------------------------------ timing


def riccati_macs(n, m, e, second_order=False, levels=1):
    """Multiply-adds one lane's step of the ladder needs: the terms that do
    not depend on V (tmp, tmp2, the e-row products of Qx, Qu, Qxx, Quu, Qux
    and, with ``second_order``, tmp·eq.. over the rank-3 slabs) once, and for
    each of ``levels`` levels fxᵀVx, fuᵀVx, Vxx·[fx fu], the Qxx, Quu and Qux
    blocks of [fx fu]ᵀ·(·) (Qxu = Quxᵀ is not formed again), Vx·f.. with
    ``second_order``, the Cholesky of Quu, the 1 + n solves and the V
    update."""
    free = e + e * n + 2 * e * n + e * m + 2 * e * n * n + e * m * m + e * m * n
    per_level = n * (n + m) + n * n * (n + m) + n * (n * n + n * m + m * m)
    per_level += m**3 // 3 + (1 + n) * m * m + m * n * (1 + n)
    if second_order:
        free += e * (n * n + m * n + m * m)
        per_level += n * (n * n + m * n + m * m)
    return free + levels * per_level


def riccati_bound_ms(Tk, n, m, e, Bk, second_order=False, levels=1, item=4):
    """Least time for one call of the ladder: every input element (the
    per-step blocks, the terminal Vx, Vxx, μ and the levels) read once and
    every output element (k, K, ok, reg_used) written once at the card's
    memory rate, or ``riccati_macs`` at the peak of the type (``item`` bytes
    a value)."""
    rows_in = sum(rs._rows(n, m, e, second_order).values())
    elems = Tk * Bk * (rows_in + m + m * n) + Bk * (n + n * n + 2 + levels)
    bytes_ms = 1e3 * (elems * item + Bk) / HBM_BYTES_PER_S
    peak = F32_FLOPS_PER_S if item == 4 else F64_FLOPS_PER_S
    ops_ms = 1e3 * 2 * riccati_macs(n, m, e, second_order, levels) * Tk * Bk / peak
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# operations of one step of the pendulum: Euler (a = -(g/l) sin q + u/m: 4;
# q' and v': 4) or RK4 (u/m once, four accelerations of 3, the stages'
# arguments 12 and increments 9, the weighted sums 14); of each cost kind's
# stage cost with its sum into the step's (control (c/2) u²: 3, tracking
# 12, manifold tracking 13) and its terminal cost (0, 8, 10)
DYN_FLOPS = (8, 39)
STAGE_FLOPS = (3, 12, 13)
TERMINAL_FLOPS = (0, 8, 10)
STEP_FLOPS = DYN_FLOPS[0] + STAGE_FLOPS[0]  # the headline's class


def flat_ops(problem):
    """What the flat-lane FUNCTION computes for ``problem``, for the bounds of
    #4 and #5: a step's dynamics and stage cost, the terminal cost, one
    evaluation of every constraint row at a step (each leaf's advance layers
    by their integrators, and its rows), the steps and the (step, row) pairs
    the mask marks (this run's schedule)."""
    flat = pack_problem(problem)
    eq = sum(sum(DYN_FLOPS[i] for i in layers) + LEAF_ROWS[kind] for kind, layers in flat.leaves)
    return dict(step=DYN_FLOPS[flat.dynamics] + STAGE_FLOPS[flat.cost], terminal=TERMINAL_FLOPS[flat.cost],
                eq=eq, steps=len(flat.active_ts), rows=int(flat.mask.sum()))  # fmt: skip


def linesearch_bound_ms(Tk, nx, m, e, Bk, n_cand, ops=None):
    """Least time for one float32 line search: every input (xs, us, k, K, the
    multipliers, mu) and output (xs, us, step) element moved once at the
    card's memory rate, or the operations of the FUNCTION — the n_cand
    candidate rollouts and the incumbent's cost, no second rollout: per step
    x - xs, the feedback law, the dynamics and the stage cost; at each
    masked step the constraint rows and per active row the multiplier p and
    the AL terms; the terminal cost — at the float32 peak.  ``ops``:
    ``flat_ops`` of the problem (default the headline's: Euler, the control
    cost, one row behind two layers at one step)."""
    if ops is None:
        ops = dict(step=STEP_FLOPS, terminal=0, eq=2 * DYN_FLOPS[0] + 1, steps=1, rows=e)
    item = 4
    per_lane = (Tk + 1) * nx + Tk * (2 * m + m * nx + e + e * nx) + 1
    per_lane += (Tk + 1) * nx + Tk * m + 1
    bytes_ms = 1e3 * per_lane * Bk * item / HBM_BYTES_PER_S
    step = nx + 2 * m * (1 + nx) + ops["step"]
    per_row = 2 * nx + 7  # the mask, p = pe + pex·dx, p·ce + (μ/2)·ce², the sum
    flops = Bk * (n_cand + 1) * (Tk * step + ops["steps"] * ops["eq"] + ops["rows"] * per_row
                                 + ops["terminal"])  # fmt: skip
    ops_ms = 1e3 * flops / F32_FLOPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def flat_solve_chain_steps(Tk, n_iters, threads_per_lane):
    """Length of one lane's dependent chain in the whole-solve program, in
    step evaluations: the initial rollout, then per pass the derivatives (and
    re-anchoring) spread over the lane's threads, the backward sweep (the
    incumbent's cost beside it), one candidate rollout (the others beside
    it) and the commit spread over the threads, per iteration also one
    adjoint sweep (the other beside it), and the final pass's derivatives and
    adjoint sweep."""
    spread = -(-Tk // threads_per_lane)
    return Tk + (n_iters + 1) * (2 * Tk + 2 * spread) + n_iters * Tk + spread + Tk


def flat_solve_bound_ms(Tk, nx, m, e, Bk, n_iters, n_ls, ops=None):
    """Least time for one float32 whole solve: x0, us0 and the schedule state
    read once and the result (us, xs, fb_k, fb_K, six stats, multipliers)
    written once at the card's memory rate, or the operations of the FUNCTION
    at the float32 peak: per pass and step the derivatives (3 Jacobian columns
    of the step, the cost's gradient and Hessian: ~40 for the headline's
    class, scaled by the class's step operations), the Riccati step
    (``riccati_bound_ms``'s count), n_ls + 1 closed-loop cost evaluations, and
    per iteration the two adjoints (~2·nx·(nx + m) multiply-adds each); the
    constraint's value and Jacobian once a pass are left out.  ``ops``:
    ``flat_ops`` of the problem (default the headline's)."""
    step_flops = STEP_FLOPS if ops is None else ops["step"]
    derivs = 40 * step_flops / STEP_FLOPS
    item = 4
    per_lane = nx + Tk * m + 4
    per_lane += Tk * m + (Tk + 1) * nx + Tk * m + Tk * m * nx + 6 + Tk * e * (1 + nx)
    bytes_ms = 1e3 * per_lane * Bk * item / HBM_BYTES_PER_S
    macs = nx * nx * (nx + m) + (nx + m) * nx * (nx + m) + 2 * e * (nx + m) * nx
    macs += m**3 // 3 + (1 + nx) * m * m + m * nx * (1 + nx)
    rollout_step = nx + 2 * m * (1 + nx) + step_flops
    per_pass = Tk * (derivs + 2 * macs + (n_ls + 1) * rollout_step)
    per_iter = Tk * (derivs + 2 * 2 * 2 * nx * (nx + m))
    flops = Bk * (Tk * step_flops + (n_iters + 1) * per_pass + (n_iters + 1) * per_iter)
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
    - nv tangents, at twice the cost each, of RNEA(q, v, a) at the primal a
      for ∂/∂q: the kinematics, the inertias and the RNEA with the joint
      accelerations (6 multiply-adds a body), no composite inertias and no
      M, since ∂_q bias + (∂_q M)·a is that one tangent; and nv tangents of
      the RNEA part alone for ∂/∂v (∂M/∂v = 0: no kinematics, no inertia, no
      M);
    - one Cholesky factor nv³/3 and 3·nv + 1 forward/backward substitutions
      of 2·nv² each."""
    nv = len(parents)
    pairs = 0
    for j in range(nv):
        i = j
        while i >= 0:
            pairs, i = pairs + 1, parents[i]
    rnea = nv * (260 + 6)
    chain = nv * (210 + 180 + 42) + rnea + 2 * (36 * nv + 6 * pairs)
    rnea_at_a = nv * (210 + 180) + rnea + 2 * 6 * nv
    return chain + nv * 2 * rnea_at_a + nv * 2 * rnea + nv**3 // 3 + (3 * nv + 1) * 2 * nv * nv


def fd_bound_ms(model, N, item=4):
    """Least time for one call on N samples: 3·nv inputs and nv + 3·nv²
    outputs per sample moved once at the card's memory rate, or ``fd_flops``
    at the peak of the type (``item`` bytes a value)."""
    nv = model.nv
    bytes_ms = 1e3 * N * (3 * nv + nv + 3 * nv * nv) * item / HBM_BYTES_PER_S
    peak = F32_FLOPS_PER_S if item == 4 else F64_FLOPS_PER_S
    ops_ms = 1e3 * fd_flops(tuple(model.parents)) * N / peak
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


def fd2_bound_ms(model, N, item=4):
    """Least time for one call on N samples: 3·nv inputs and
    nv + 3·nv² + nv·(3·nv)² outputs per sample moved once at the card's
    memory rate, or ``fd2_flops`` at the peak of the type (``item`` bytes a
    value)."""
    nv = model.nv
    bytes_ms = 1e3 * N * (3 * nv + nv + 3 * nv * nv + 9 * nv**3) * item / HBM_BYTES_PER_S
    peak = F32_FLOPS_PER_S if item == 4 else F64_FLOPS_PER_S
    ops_ms = 1e3 * fd2_flops(tuple(model.parents)) * N / peak
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def event_ms(fn, reps=20, warm=True):
    """Median over ``reps`` single calls of the device time between CUDA
    events around ``fn`` (after one warm-up call unless ``warm`` is False:
    a plain version that ran on the same inputs before, whose call takes
    seconds)."""
    if warm:
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


def device_ms(fn, n=50, sleep_cycles=50_000_000):
    """Device time of one call of ``fn`` with ``n`` calls back to back: a
    sleep kernel holds the stream while the host enqueues them, so the host's
    submission time, which ``event_ms`` of one launch includes, does not
    count (CUDA events around the n calls)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    check(not a.query(), "device_ms: the sleep ended before the launches were enqueued")
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def time_ladder(card, label, triplet, n_levels, shape, second_order=False):
    """The ladder kernel on a launch plan (the kernel alone), the wrapper's
    whole call (its checks, layout copies and allocations included) and the
    plain version on phase 3's inputs (CUDA events, median of 20, 20 and 2),
    beside the bound of the call."""
    inputs, mu, reg = triplet
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    plan = rs.plan_launch(*inputs, mu, levels, second_order)
    ms = event_ms(lambda: rs.launch_plan(plan))
    call_ms = event_ms(lambda: rs.backward_ladder(*inputs, mu, levels, second_order))
    plain_ms = event_ms(lambda: rs.backward_ladder_reference(*inputs, mu, levels, second_order), reps=2,
                        warm=False)  # fmt: skip
    item = mu.element_size()
    bound, bound_by = riccati_bound_ms(*shape, second_order, n_levels, item)
    Tk, *_, Bk = shape
    say("time_backward" + ("_2nd_order" if second_order else ""), card=f"'{card}'",
        shape=f"{label}_T{Tk}_B{Bk}_L{n_levels}_{str(mu.dtype)[6:]}", kernel_ms=f"{ms:.4f}",
        wrapper_call_ms=f"{call_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
        bound_by=bound_by, kernel_over_bound=f"{ms / bound:.1f}")  # fmt: skip
    return dict(ms=ms, wrapper_call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


def solve(problem, x0s, backward):
    res = solve_batched(problem, HEADLINE, x0s, backward=backward, **HEADLINE_KW)
    torch.cuda.synchronize()
    return res


def main_path():
    """Phase 4: the headline solve through the kernel, its checks, and the
    sweep-backend and f64 comparisons.  Returns (launches, problem, x0s)."""
    p32 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float32)
    x32 = headline_x0s(torch.float32)
    reset_launch_counts()
    res_k = solve(p32, x32, "kernel")
    launches = rs.LAUNCHES
    check(launches == EXPECTED_LAUNCHES, f"kernel launches {launches} != {EXPECTED_LAUNCHES}")
    check(rs.LEVELS_SWEPT == EXPECTED_LAUNCHES, f"levels swept {rs.LEVELS_SWEPT}")
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


# --------------------------------------------- phase 12: assoc and the envelope


def pendulum_problem(horizon, dtype):
    return problem_from_numpy(dict(SPEC, horizon=horizon, active_ts=(horizon,)), device=DEV, dtype=dtype)


def finished_inputs(problem, res):
    """A finished solve's backward inputs: (derivs, mult_val, mult_jac), μ, reg."""
    derivs = problem.derivatives(res.xs, res.us)
    return (derivs, res.mults.val, res.mults.jac), res.mu, res.reg


def device_profile(fn):
    """Device kernels one call of ``fn`` launches and their summed device
    time in ms (torch.profiler; the busy time, not the call's span)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events) / 1e3


def check_route(res, what, Bk, Tk):
    for name in RESULT_FIELDS:
        check(bool(torch.isfinite(getattr(res, name)).all()), f"{what}: non-finite {name}")
    check(res.us.shape == (Bk, Tk, 1) and res.xs.shape == (Bk, Tk + 1, 2), f"{what}: shapes")
    return float((res.opt_constr < 1e-2).float().mean())


def backward_times(card, label, routes, reps=None):
    """Each backward route's call on one finished solve's inputs: CUDA events
    around one call (median of 20, or of ``reps[route]``), and by
    torch.profiler the device kernels of one call and their summed device
    time (``device_ms`` cannot time the PyTorch routes: the host takes
    longer to queue their calls than the sleep holds the stream)."""
    out = {}
    for name, fn in routes.items():
        kernels, busy = device_profile(fn)  # the profiled call is the warm-up
        out[name] = dict(ms=event_ms(fn, reps=(reps or {}).get(name, 20), warm=False), device_busy_ms=busy,
                         device_kernels=kernels)  # fmt: skip
    say("time_backward_routes", card=f"'{card}'", shape=label,
        **{f"{k}_{n}": (f"{v:.4f}" if isinstance(v, float) else v)
           for n, r in out.items() for k, v in r.items()})  # fmt: skip
    return out


def assoc_headline(card):
    """Phase 12a: the headline through backward="assoc" (no Riccati kernel
    launch), its share against ddp_tpu's, lane agreement with the kernel
    route, the scan's bits with TF32 allowed around it, and f64 at 16 lanes
    against the sweep."""
    p32, x32 = pendulum_problem(T, torch.float32), headline_x0s(torch.float32)
    reset_launch_counts()
    res_a = solve(p32, x32, "assoc")
    counts = launch_counts()
    check(counts == dict(riccati=0, fd=0, fd2=0, linesearch=0, flat_solve=0),
          f"assoc headline: launches {counts}")  # fmt: skip
    feas = check_route(res_a, "assoc headline", B, T)
    check(feas >= ASSOC_JAX_CPU_SHARE - 0.01,
          f"assoc headline share {feas} below ddp_tpu's {ASSOC_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    res_k = solve(p32, x32, "kernel")
    agree, worst = lane_agreement(res_a, res_k)
    check(agree >= 0.99, f"assoc headline: only {agree} of lanes agree with the kernel route")
    inputs, mu, reg = finished_inputs(p32, res_a)

    def scan(unwrap=lambda f: f):
        return unwrap(backward_pass_assoc)(*inputs, mu, reg)

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        full = scan()
        torch.backends.cuda.matmul.allow_tf32 = True
        guarded, unguarded = scan(), scan(lambda f: f.__wrapped__)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    same = [torch.equal(a, b) for a, b in zip(full, guarded)]
    check(all(same), "assoc: the pinned scan changed with TF32 allowed around it")

    p64 = pendulum_problem(T, torch.float64)
    x64 = headline_x0s(torch.float64)[:16]
    r64_a, r64_s = solve(p64, x64, "assoc"), solve(p64, x64, "sweep")
    err64 = lane_scaled_err(r64_a, r64_s)
    mu_parts = torch.nonzero(r64_a.mu != r64_s.mu).flatten().tolist()
    say("assoc_headline", B=B, T=T, riccati_launches=counts["riccati"], launches=counts,
        feasible=feas, feasible_ddp_tpu_cpu=ASSOC_JAX_CPU_SHARE, lanes_us_agree_kernel=agree,
        us_max_scaled_err_kernel=f"{worst:.3e}", mu_equal_kernel=float((res_a.mu == res_k.mu).float().mean()),
        tf32_pinned_bit_exact=True,
        tf32_unguarded_changes=not all(torch.equal(a, b) for a, b in zip(full, unguarded)),
        f64_B=16, f64_us_max_scaled_err=f"{err64:.3e}", f64_mu_lanes_parted=mu_parts)  # fmt: skip
    check(err64 <= 1e-8, f"assoc f64 us max scaled err {err64} (μ parted on lanes {mu_parts})")
    check(not mu_parts, f"assoc f64 per-lane μ parts from the sweep's on lanes {mu_parts}")
    return dict(feasible=feas, lanes_agree=agree, riccati_launches=counts["riccati"])


def t200_row(card):
    """Phase 12b: bench.py's T200 row through assoc, sweep and kernel, one
    solve each, timed (phase 12a has warmed every route at T = 32; to keep
    the whole run near 850 s no solve is repeated): shares, lane agreement
    with the kernel route, solves/s; kernel #1 against its plain version on
    the kernel route's finished inputs; and each backward's call on them."""
    p32, x32 = pendulum_problem(T200, torch.float32), headline_x0s(torch.float32)
    out, res = {}, {}
    for route in ("assoc", "sweep", "kernel"):
        reset_launch_counts()
        t0 = time.perf_counter()
        res[route] = solve_batched(p32, HEADLINE, x32, backward=route, **T200_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = EXPECTED_LAUNCHES if route == "kernel" else 0
        check(counts == dict(riccati=expected, fd=0, fd2=0, linesearch=0, flat_solve=0),
              f"T200 {route}: launches {counts}")  # fmt: skip
        out[route] = dict(feasible=check_route(res[route], f"T200 {route}", B, T200), solve_s=wall,
                          solves_per_s=B / wall, riccati_launches=counts["riccati"])  # fmt: skip
    check(out["assoc"]["feasible"] >= ASSOC_T200_JAX_CPU_SHARE - 0.01,
          f"T200 assoc share {out['assoc']['feasible']} below ddp_tpu's {ASSOC_T200_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    for route in ("assoc", "sweep"):
        agree, worst = lane_agreement(res[route], res["kernel"])
        bar = T200_JAX_CPU_AGREE[route] - 0.02
        out[route].update(lanes_us_agree_kernel=agree, us_max_scaled_err_kernel=worst,
                          mu_equal_kernel=float((res[route].mu == res["kernel"].mu).float().mean()))  # fmt: skip
        check(agree >= bar, f"T200 {route}: only {agree} of lanes agree with the kernel route (bar {bar})")
    say("t200_row", B=B, T=T200, **{f"{k}_{r}": (f"{v:.4f}" if isinstance(v, float) else v)
                                    for r, d in out.items() for k, v in d.items()})  # fmt: skip
    out["B"] = t200_path_b(card, p32, x32, res["sweep"])

    inputs, mu, reg = finished_inputs(p32, res["kernel"])
    # kernel #1 on this row's own inputs against its plain version: float64
    # copies at 1e-10, and float32 no further from float64 than twice the
    # plain float32 version
    out["kernel_f32_from_f64"], out["plain_f32_from_f64"], out["kernel_err32"] = kernel_f32_vs_f64(
        f"t200_f32_B{B}_T{T200}", inputs, mu, reg, 1)  # fmt: skip
    wide = (precise.wide(inputs[0]), inputs[1].double(), inputs[2].double())
    out["kernel_err64"] = kernel_vs_plain(f"t200_f64_B{B}_T{T200}", wide, mu.double(), reg.double(), 1,
                                          1e-10, 1e-10)[0]  # fmt: skip
    levels = torch.stack(_reg_levels(mu, reg, 1))
    routes = {
        "assoc": lambda: backward_pass_assoc(*inputs, mu, reg),
        "sweep": lambda: _backward_multi_reg(*inputs, mu, reg, 1),
        "kernel": lambda: rs.backward_ladder(*inputs, mu, levels),
    }
    out["backward"] = backward_times(card, f"n2m1e1_T{T200}_B{B}_f32", routes, dict(sweep=1, assoc=1))
    plan = rs.plan_launch(*inputs, mu, levels)
    out["backward"]["kernel"]["device_ms"] = device_ms(lambda: rs.launch_plan(plan))
    out["bound_ms"], out["bound_by"] = riccati_bound_ms(T200, 2, 1, 1, B, levels=1, item=4)
    return out


def t200_path_b(card, p32, x32, res_sweep):
    """Phase 12b, path B: bench.py's T200 row through the one-launch whole
    solve (``solve_flat``, #5's streamed program), held as phase 4 holds path
    B: exactly 1 launch and no other, finite results, the feasible share
    against ddp_tpu's on the CPU less 0.01, f32 lane agreement with the sweep
    route against ddp_tpu's own agreement there less 0.02, and f64 at 64
    lanes, in the streamed program too (the plan would take the resident one
    there), within 1e-8 of each lane's |u| of the sweep route with identical
    μ (or within 10× what a 1e-15 change of x0 does to the sweep route, where
    that is larger: near convergence a step's Δcost ≤ 0 is a roundoff draw).
    The streamed program against its plain version in f64 at 1024 lanes
    (``flat_solve_vs_plain``'s bars).  Then the kernel on the row's launch
    plan (the streamed program, checked), timed beside its bound.  Returns
    the numbers of the kernels' JSON."""
    n_ls = HEADLINE_KW["n_linesearch"]
    res, counts, wall = flat_route(p32, HEADLINE, x32, "B", n_ls)
    expected = dict(riccati=0, fd=0, fd2=0, linesearch=0, flat_solve=1, levels_swept=0)
    check(counts == expected, f"T200 B: launches {counts} != {expected}")
    share = check_route(res, "T200 B", B, T200)
    check(share >= ASSOC_T200_JAX_CPU_SHARE - 0.01,
          f"T200 B share {share} below ddp_tpu's {ASSOC_T200_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    agree, worst = lane_agreement(res, res_sweep)
    bar = T200_JAX_CPU_AGREE["sweep"] - 0.02
    check(agree >= bar, f"T200 B: only {agree} of lanes agree with the sweep route (bar {bar})")
    p64, x64 = pendulum_problem(T200, torch.float64), headline_x0s(torch.float64)[:STATE_B64]

    def sweep64(x):
        out_ = solve_batched(p64, HEADLINE, x, backward="sweep", **T200_KW)
        torch.cuda.synchronize()
        return out_

    # the f32 row's program: at 64 lanes the plan would take the resident one
    plan64 = fs.plan_launch(p64, HEADLINE, x64, n_linesearch=n_ls, _program="streamed")
    b64, s64 = fs.launch_plan(plan64), sweep64(x64)
    check(plan64.geometry["program"] == "streamed", f"T200 B f64: plan {plan64.geometry}")
    err64, bar64 = lane_scaled_err(b64, s64), 1e-8
    if err64 > bar64:
        bar64 = resolution_bars(bar64, sweep64, x64, lambda r: {"us": lane_scaled_err(r, s64)})[0]["us"]
    check(err64 <= bar64, f"T200 B: f64 us max scaled err {err64}, bar {bar64:.1e}")
    check(torch.equal(b64.mu, s64.mu), "T200 B: f64 per-lane mu differs")
    # the streamed program against its plain version in f64 at this row's
    # shape (8 iterations)
    Bp = 1024
    plain64 = flat_solve_vs_plain(f"fs_headline_f64_streamed_B{Bp}_T{T200}", torch.float64, Bp,
                                  spec=flat_class_spec("headline", T200), resolution=True, program="streamed")  # fmt: skip
    plan = fs.plan_launch(p32, HEADLINE, x32, n_linesearch=n_ls)
    check(plan.geometry["program"] == "streamed", f"T200 B: plan {plan.geometry}")
    out = dict(launches=counts["flat_solve"], feasible=share, lanes_us_agree_sweep=agree, us_max_scaled_err=worst,
               f64_us_max_scaled_err=err64, f64_bar=bar64, solve_s=wall, solves_per_s=B / wall,
               plain_f64_us_max_abs_err=plain64[0], plain_f64_s=plain64[1],
               ms=event_ms(lambda: fs.launch_plan(plan), reps=3),
               device_ms=device_ms(lambda: fs.launch_plan(plan), n=5))  # fmt: skip
    out["bound_ms"], out["bound_by"] = flat_solve_bound_ms(T200, 2, 1, 1, B, HEADLINE.max_iterations, n_ls)
    out["plan"] = dict(plan.geometry)
    say("t200_path_b", card=f"'{card}'", B=B, T=T200, launches=counts, feasible=share,
        feasible_ddp_tpu_cpu=ASSOC_T200_JAX_CPU_SHARE, lanes_us_agree_sweep=agree, agree_bar=f"{bar:.4f}",
        us_max_scaled_err=f"{worst:.3e}", f64_B=STATE_B64, f64_us_max_scaled_err=f"{err64:.3e}",
        f64_bar=f"{bar64:.1e}", f64_mu_identical=True, solve_s=f"{wall:.4f}", solves_per_s=f"{B / wall:.1f}",
        kernel_ms=f"{out['ms']:.4f}", kernel_device_ms=f"{out['device_ms']:.4f}",
        bound_ms=f"{out['bound_ms']:.5f}", bound_by=out["bound_by"], plan=out["plan"])  # fmt: skip
    return out


def tf_headline(card):
    """Phase 12c: the headline through backward="tf" with precise_cost=True,
    and one tf backward call on its finished inputs held against kernel #1's
    float64 instantiation at (2, 1, 1) on float64 copies of them at the same
    ladder levels (one launch)."""
    p32, x32 = pendulum_problem(T, torch.float32), headline_x0s(torch.float32)
    reset_launch_counts()
    res = solve_batched(p32, HEADLINE, x32, backward="tf", precise_cost=True, **HEADLINE_KW)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts["riccati"] == 0, f"tf headline: Riccati launches {counts}")
    feas = check_route(res, "tf headline", B, T)
    bar = min(0.99, TF_JAX_CPU_SHARE - 0.01)
    check(feas >= bar, f"tf headline share {feas} below {bar}")
    check(all(b.dtype == torch.float32 for b in p32.buffers()), "tf headline: the problem changed dtype")
    inputs, mu, reg = finished_inputs(p32, res)
    n_levels = HEADLINE_KW["n_reg_levels"]
    k, K, ok, reg_used = _backward_multi_reg(*inputs, mu, reg, n_levels, sweep=precise.backward_sweep)
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    wide = (precise.wide(inputs[0]), inputs[1].double(), inputs[2].double())
    reset_launch_counts()
    k64, K64, ok64, reg64 = rs.backward_ladder(*wide, mu.double(), levels.double())
    torch.cuda.synchronize()
    yard_launches = rs.LAUNCHES
    check(yard_launches == 1, f"tf yardstick: {yard_launches} launches of kernel #1 f64")
    check(torch.equal(ok, ok64), "tf yardstick: ok differs from kernel #1 f64")
    check(torch.equal(reg_used.double(), reg64), "tf yardstick: reg_used differs from kernel #1 f64")
    eps32 = float(torch.finfo(torch.float32).eps)
    abs_errs = [float((a.double() - b).abs()[ok].max()) for a, b in ((k, k64), (K, K64))]
    errs = [e / float(b.abs()[ok].max()) for e, b in zip(abs_errs, (k64, K64))]
    check(max(errs) <= 2 * eps32, f"tf yardstick: gains {errs} of the largest entry (bar 2·eps32)")
    times = dict(
        tf_ms=event_ms(lambda: _backward_multi_reg(*inputs, mu, reg, n_levels, sweep=precise.backward_sweep)),
        kernel_f32_ms=event_ms(lambda: rs.backward_ladder(*inputs, mu, levels)),
        kernel_f64_ms=event_ms(lambda: rs.backward_ladder(*wide, mu.double(), levels.double())),
        kernel_f64_plain_ms=event_ms(
            lambda: rs.backward_ladder_reference(*wide, mu.double(), levels.double()), reps=5),
    )  # fmt: skip
    plan = rs.plan_launch(*wide, mu.double(), levels.double())
    times["kernel_f64_device_ms"] = device_ms(lambda: rs.launch_plan(plan))
    bound, bound_by = riccati_bound_ms(T, 2, 1, 1, B, levels=n_levels, item=8)
    say("tf_headline", card=f"'{card}'", B=B, T=T, launches=counts, feasible=feas, feasible_bar=bar,
        feasible_ddp_tpu_cpu=TF_JAX_CPU_SHARE, yardstick="riccati_small f64 (2,1,1)",
        yardstick_riccati_launches=yard_launches, ok_equal=True, reg_used_equal=True,
        k_rel_err=f"{errs[0]:.3e}", K_rel_err=f"{errs[1]:.3e}", bar=f"{2 * eps32:.3e}",
        k_abs_err=f"{abs_errs[0]:.3e}", K_abs_err=f"{abs_errs[1]:.3e}",
        **{k_: f"{v:.4f}" for k_, v in times.items()}, kernel_f64_bound_ms=f"{bound:.5f}",
        kernel_f64_bound_by=bound_by)  # fmt: skip
    return dict(times, feasible=feas, launches=yard_launches, max_abs_err=max(abs_errs), max_rel_err=max(errs),
                bound_ms=bound, bound_by=bound_by)


def precise_run(mode, thr, x0):
    """One ddp_tpu_torch.solve(precise=``mode``) of phase 12d on
    test_precise.py's T = 60 configuration (f32, mu 1e6, 40 iterations):
    its wall time and what the bars read; a worker process's task too."""
    p32 = pendulum_problem(PRECISE_H, torch.float32)
    t0 = time.perf_counter()
    r = ddp_solve(p32, SolverParams(40, thr, mu=1e6), torch.tensor(x0, device=DEV), precise=mode)
    torch.cuda.synchronize()
    return dict(wall_s=time.perf_counter() - t0, q_T=float(r.xs[-1, 0]), opt_lag=float(r.stats.opt_lag),
                opt_constr=float(r.stats.opt_constr), mu=float(r.stats.mu),
                iterations=int(r.stats.iterations), finite=bool(torch.isfinite(r.us).all()),
                float32=all(x.dtype == torch.float32 for x in (r.xs, r.us, r.mults.val, r.stats.opt_lag)),
                problem_float32=all(b.dtype == torch.float32 for b in p32.buffers()))  # fmt: skip


def precise_solves(card):
    """Phase 12d: ddp_tpu_torch.solve(precise=True) and precise="storage"
    beside the plain float32 solve from the 22 starts of precise_starts():
    every start in ``PRECISE_WORKERS`` processes (wall times in the pool).  Bars: finite float32 results and the
    caller's problem unchanged, q_T (1e-2 plain and envelope, 1e-3 storage)
    and the storage mode's opt_constr < 1e-10 from every start, the
    envelope's opt_constr within 1.5× the plain solve's from x0 = 0 (the
    anchor's start); the envelope below the plain solve's opt_lag from at
    least ``ENVELOPE_MIN_BELOW`` starts and the storage mode below 1e-8 from
    at least ``STORAGE_MIN_MET``."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    modes = ((False, 1e-7), (True, 1e-7), ("storage", 1e-9))
    starts = [x.tolist() for x in precise_starts()]
    t0 = time.perf_counter()
    # one intra-op thread a worker: eight processes share the host's cores
    with ProcessPoolExecutor(PRECISE_WORKERS, mp_context=get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(1,)) as pool:  # fmt: skip
        futures = [[pool.submit(precise_run, m, th, x0) for m, th in modes] for x0 in starts]
        rows = [[f.result() for f in fs] for fs in futures]
    pool_s = time.perf_counter() - t0
    solo = rows[0]
    for x0, row in zip(starts, rows):
        for (mode, _), r in zip(modes, row):
            what = f"precise={mode!r} from {x0}"
            check(r["finite"] and r["float32"] and r["problem_float32"], f"{what}: results {r}")
            check(abs(r["q_T"] - 3.14) <= (1e-3 if mode == "storage" else 1e-2), f"{what}: q_T {r['q_T']}")
        check(row[2]["opt_constr"] < 1e-10, f"storage opt_constr {row[2]['opt_constr']} from {x0}")
    plain, env, storage = solo
    below = sum(r[1]["opt_lag"] < r[0]["opt_lag"] for r in rows)
    met = sum(r[2]["opt_lag"] < 1e-8 and r[2]["opt_constr"] < 1e-10 for r in rows)
    say("precise_solves", card=f"'{card}'", H=PRECISE_H, starts=len(starts),
        **{f"{k}_{n}": f"{v:.4e}" for n, d in (("plain", plain), ("envelope", env), ("storage", storage))
           for k, v in d.items() if isinstance(v, float)},
        envelope_below_plain=f"{below}/{len(starts)}", envelope_bar=ENVELOPE_MIN_BELOW,
        envelope_below_ddp_tpu_cpu=PRECISE_JAX_CPU_ENVELOPE_BELOW,
        storage_met=f"{met}/{len(starts)}", storage_bar=STORAGE_MIN_MET,
        storage_met_ddp_tpu_cpu=PRECISE_JAX_CPU_STORAGE_MET, workers=PRECISE_WORKERS,
        workers_wall_s=f"{pool_s:.1f}", wall_s_timed="in_the_pool")  # fmt: skip
    for x0, row in zip(starts, rows):
        say("precise_start", x0=x0, **{f"{n}": f"({r['opt_lag']:.3e},{r['mu']:.0e},{r['opt_constr']:.1e})"
                                      for n, r in zip(("plain", "envelope", "storage"), row)})  # fmt: skip
    check(env["opt_constr"] <= 1.5 * plain["opt_constr"],
          f"envelope opt_constr {env['opt_constr']} vs plain {plain['opt_constr']}")  # fmt: skip
    check(below >= ENVELOPE_MIN_BELOW, f"envelope below the plain solve from {below} of {len(starts)} starts")
    check(met >= STORAGE_MIN_MET, f"storage: opt_lag < 1e-8 from {met} of {len(starts)} starts")
    return dict(plain=plain, envelope=env, storage=storage, envelope_below=below, storage_met=met)


def assoc_and_envelope(card):
    """Phase 12: the associative-scan backward and the precision envelope."""
    t0 = time.perf_counter()
    out = dict(a=assoc_headline(card), b=t200_row(card), c=tf_headline(card), d=precise_solves(card))
    say("phase12", wall_s=f"{time.perf_counter() - t0:.1f}")
    return out


# ------------------------------------------------------ the sharded paths


def fleet_x0s(dtype, n):
    """Distinct fleet starts: q ~ U(-π, π), v ~ U(-1, 1) from default_rng(3)."""
    rng = np.random.default_rng(3)
    x0 = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-1.0, 1.0, n)], axis=1)
    return torch.tensor(x0, dtype=dtype, device=DEV)


def fleet_replans(problem, mesh, x, n):
    """``n`` fleet replans (make_batch_mpc_step through #1) from the global
    starts ``x``, the carry carried and each rank's plant stepped on its own
    block between replans (outside the timed window).  Returns each replan's
    u0 (this rank's block, on the host), #1 launches, synchronized wall
    seconds and mean_constr, and the last carry's μ (this rank's block)."""
    step = mpc.make_batch_mpc_step(problem, FLEET, mesh, backward="kernel")
    carry = mpc.init_batch_carry(problem, x.shape[0], x0s=x)
    x_local = pmesh.local_block(x, mesh)
    u0s, launches, walls, means = [], [], [], []
    for _ in range(n):
        reset_launch_counts()
        t0 = time.perf_counter()
        u0, carry, mean_c = step(x, carry)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(rs.LAUNCHES)
        u0 = u0.to_local()
        u0s.append(u0.cpu())
        means.append(float(mean_c))
        x_local = problem.dynamics(0, x_local, u0)
        x = DTensor.from_local(x_local, mesh, [Shard(0)])
    local = [a.to_local() for a in carry_leaves(carry)]
    check(all(bool(torch.isfinite(a).all()) for a in local + u0s), "fleet replan: non-finite u0 or carry")
    return dict(u0=u0s, launches=launches, walls=walls, mean_constr=means, mu=carry.mu.to_local().cpu())


def sharded_runs(mesh, n_fleet):
    """The three sharded functions at their global widths on this rank's
    block of ``mesh``: the headline through ``batch_sharded_solve_batched``
    with #1 (9 launches on every rank), ``batch_sharded_solve`` on entry()'s
    problem (B = 4096, full DDP, no kernel), ``n_fleet`` fleet replans at
    B = 32,768 (4 launches of #1 a replan on every rank); the same three
    in f64 at 64 lanes.  Returns this rank's blocks on the host."""
    out = {}
    for dtype, n_lanes, n_replans in ((torch.float32, None, n_fleet), (torch.float64, SPLIT_B64, SPLIT_FLEET_REPLANS)):
        tag = str(dtype)[6:]
        p = problem_from_numpy(SPEC, device=DEV, dtype=dtype)
        x = headline_x0s(dtype)[:n_lanes]
        reset_launch_counts()
        res, stats = pmesh.batch_sharded_solve_batched(p, HEADLINE, mesh, backward="kernel", **HEADLINE_KW)(x)
        torch.cuda.synchronize()
        check(rs.LAUNCHES == EXPECTED_LAUNCHES, f"sharded headline {tag}: #1 launches {rs.LAUNCHES}")
        out["headline_" + tag] = dict(
            us=res.us.to_local().cpu(), mu=res.mu.to_local().cpu(), opt_constr=res.opt_constr.to_local().cpu(),
            mean_constr=float(stats["mean_constr"]), launches=rs.LAUNCHES,
        )  # fmt: skip
        pe, params = entry_mod._make_problem(T, dtype, device=DEV)
        reset_launch_counts()
        us, stats = pmesh.batch_sharded_solve(pe, params, mesh)(headline_x0s(dtype)[:n_lanes])
        torch.cuda.synchronize()
        check(rs.LAUNCHES == 0, f"sharded solve_vmap {tag}: #1 launches {rs.LAUNCHES}")
        out["entry_" + tag] = dict(us=us.to_local().cpu(), mean_constr=float(stats["mean_constr"]),
                                   n_converged=int(stats["n_converged"]))  # fmt: skip
        fleet = fleet_replans(p, mesh, fleet_x0s(dtype, n_lanes or FLEET_B), n_replans)
        check(all(n == FLEET_LAUNCHES for n in fleet["launches"]), f"fleet {tag}: #1 launches {fleet['launches']}")
        out["fleet_" + tag] = fleet
    return out


def mesh_rank(rank, world, store, out_dir):
    """Phase 13b's rank: gloo, every rank on cuda:0 (``make_batch_mesh``
    takes local rank % device count)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = sharded_runs(pmesh.make_batch_mesh(device_type="cuda"), SPLIT_FLEET_REPLANS)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def feasible_share(problem, x0s, us):
    """Share of lanes whose controls, rolled out from ``x0s``, meet the
    constraint: max_t ‖eq_t‖ < 1e-2 (``batch_sharded_solve`` returns the
    controls, not the stats)."""
    eq = problem.eq_all(problem.rollout(x0s, us), us)
    return float((torch.linalg.vector_norm(eq, dim=-1).amax(dim=-1) < 1e-2).float().mean())


def lanes_within(a, b, bar):
    """Share of lanes with max |a − b| within ``bar`` of the lane's largest |b|
    (at least 1)."""
    d = (a - b).abs().flatten(1).amax(dim=1)
    return float((d <= bar * b.abs().flatten(1).amax(dim=1).clamp(min=1.0)).float().mean())


def split_checks(whole, ranks):
    """Phase 13b against 13a on the host: f32 ≥ 99% of lanes within 1e-3 of
    their largest |u|, f64 (64 lanes) within 1e-9 of each array's largest
    entry with identical μ, mean_constr within 1e-6 (f32) / 1e-12 (f64)
    relative."""
    out = {}
    for name in ("headline", "entry", "fleet"):
        for tag, bar, rel in (("float32", 1e-3, 1e-6), ("float64", 1e-9, 1e-12)):
            key = f"{name}_{tag}"
            a = whole[key]
            if name == "fleet":
                n = len(ranks[0][key]["u0"])
                got = [torch.cat([r[key]["u0"][i] for r in ranks]) for i in range(n)]
                want = a["u0"][:n]
                means = [(r[key]["mean_constr"][:n], a["mean_constr"][:n]) for r in ranks]
            else:
                got, want = [torch.cat([r[key]["us"] for r in ranks])], [a["us"]]
                means = [([r[key]["mean_constr"]], [a["mean_constr"]]) for r in ranks]
            if tag == "float32":
                agree = min(lanes_within(g, w, bar) for g, w in zip(got, want))
                check(agree >= 0.99, f"2-rank {key}: {agree} of lanes within 1e-3 of their |u|")
                out[key] = agree
            else:
                err = max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-300)) for g, w in zip(got, want))
                check(err <= bar, f"2-rank {key}: {err:.3e} of the largest entry")
                out[key] = err
                if "mu" in a:
                    mu = torch.cat([r[key]["mu"] for r in ranks])
                    check(torch.equal(mu, a["mu"]), f"2-rank {key}: μ differs")
            for got_m, want_m in means:
                for gm, wm in zip(got_m, want_m):
                    check(abs(gm - wm) <= rel * abs(wm), f"2-rank {key}: mean_constr {gm} vs {wm}")
    for key in ("headline_float32", "headline_float64"):
        check([r[key]["launches"] for r in ranks] == [EXPECTED_LAUNCHES] * 2, f"2-rank {key} launches")
    return out


def sharded_paths(card):
    """Phase 13: the mesh (parallel/mesh.py), solve_vmap, make_batch_mpc_step
    and entry.py on the card.  (a) World size 1 over NCCL in this process:
    the headline through batch_sharded_solve_batched(backward="kernel"), 9
    launches of #1, us/μ/opt_constr bit for bit the unsharded solve_batched's
    and mean_constr the local mean, timed beside it; dryrun_multichip(1)'s
    contract run (feasible share > 0.99); batch_sharded_solve on entry()'s
    problem at B = 4096 beside the unsharded solve_vmap (share not below
    it), and 8 of its lanes in f64 against the per-trajectory solve (us
    within 1e-8 of each lane's |u|, identical iterations and μ); the fleet
    replan of BASELINE configs[4] at B = 32,768 through #1 (a warm-up and
    ``FLEET_REPLANS`` timed replans, 4 launches each, p50/p99 beside the
    10 ms budget, a record; #1 at that shape against its plain version and
    timed).  (b) World size 2 on the one card over gloo:
    the same three functions, each rank's launches checked, the results
    against (a)'s.  (c) The multi-GPU NCCL target stays unverified."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store", rank=0, world_size=1)
        try:
            mesh = pmesh.make_batch_mesh(1)
            whole = sharded_runs(mesh, 1 + FLEET_REPLANS)
            # the unsharded headline: the same code on the same block
            p32, x32 = problem_from_numpy(SPEC, device=DEV, dtype=torch.float32), headline_x0s(torch.float32)
            ref = solve(p32, x32, "kernel")
            h = whole["headline_float32"]
            for name in ("us", "mu", "opt_constr"):
                check(torch.equal(h[name], getattr(ref, name).cpu()), f"sharded headline {name} differs at world size 1")
            local_mean = float(ref.opt_constr.mean())
            check(abs(h["mean_constr"] - local_mean) <= 1e-6 * abs(local_mean),
                  f"sharded headline mean_constr {h['mean_constr']} vs {local_mean}")  # fmt: skip
            sharded = pmesh.batch_sharded_solve_batched(p32, HEADLINE, mesh, backward="kernel", **HEADLINE_KW)
            walls = {"sharded": [], "unsharded": []}
            for route in ("sharded", "unsharded"):
                t1 = time.perf_counter()
                sharded(x32) if route == "sharded" else solve(p32, x32, "kernel")
                torch.cuda.synchronize()
                walls[route].append(time.perf_counter() - t1)
            sps = {k: B / statistics.median(v) for k, v in walls.items()}
            say("mesh_headline", card=f"'{card}'", world=1, backend="nccl", B=B, T=T,
                launches=h["launches"], bitwise_unsharded=True, mean_constr=f"{h['mean_constr']:.6e}",
                local_mean=f"{local_mean:.6e}", solves_per_s_sharded=f"{sps['sharded']:.1f}",
                solves_per_s_unsharded=f"{sps['unsharded']:.1f}", timed="one_solve_each_sharded_first")  # fmt: skip
            out["headline"] = dict(launches=h["launches"], solves_per_s=sps, timed="one solve each, sharded first")

            row = entry_mod.dryrun_multichip(1)
            check(row["frac_feasible_1e-2"] > 0.99, f"dryrun contract share {row}")
            out["dryrun"] = row

            pe, params = entry_mod._make_problem(T, torch.float32, device=DEV)
            e = whole["entry_float32"]
            ref_e = solve_vmap(pe, params, x32)
            torch.cuda.synchronize()
            check(torch.equal(e["us"], ref_e.us.cpu()), "sharded solve_vmap differs at world size 1")
            check(abs(e["mean_constr"] - float(ref_e.stats.opt_constr.mean())) <=
                  1e-6 * float(ref_e.stats.opt_constr.mean()), "sharded solve_vmap mean_constr")  # fmt: skip
            feas = feasible_share(pe, x32, e["us"].to(DEV))
            feas_ref = feasible_share(pe, x32, ref_e.us)
            check(feas >= feas_ref, f"sharded solve_vmap feasible share {feas} below the unsharded {feas_ref}")
            pe64, params64 = entry_mod._make_problem(T, torch.float64, device=DEV)
            x64 = headline_x0s(torch.float64)[:ENTRY_B64]
            r64 = solve_vmap(pe64, params64, x64)
            worst = 0.0
            for i in range(ENTRY_B64):
                one = ddp_solve(pe64, params64, x64[i])
                err = float((r64.us[i] - one.us).abs().max() / one.us.abs().max().clamp(min=1.0))
                check(err <= 1e-8, f"solve_vmap lane {i} f64: us {err:.3e} of |u| from solve")
                check(int(r64.stats.iterations[i]) == int(one.stats.iterations)
                      and float(r64.stats.mu[i]) == float(one.stats.mu), f"solve_vmap lane {i}: iterations or μ")  # fmt: skip
                worst = max(worst, err)
            say("mesh_solve_vmap", card=f"'{card}'", world=1, B=B, T=T, iters=params.max_iterations,
                feasible_sharded=feas, feasible_unsharded=feas_ref,
                feasible_unsharded_stats=float((ref_e.stats.opt_constr < 1e-2).float().mean()),
                n_converged=e["n_converged"],
                mean_constr=f"{e['mean_constr']:.4e}", f64_lanes=ENTRY_B64, f64_us_scaled_err=f"{worst:.3e}",
                f64_iterations=r64.stats.iterations.tolist())  # fmt: skip
            out["entry"] = dict(feasible=feas, n_converged=e["n_converged"], f64_err=worst)

            f = whole["fleet_float32"]
            ms = 1e3 * np.asarray(f["walls"][1:])  # the first replan is the warm-up
            # #1 at the fleet's shape (B = 32,768, solve_batched's 4 reg
            # levels) against its plain version, and its time
            fleet_in = pendulum_inputs(FLEET_B, torch.float32)
            err32 = kernel_vs_plain(f"fleet_f32_B{FLEET_B}_T{T}_L4", *fleet_in, 4, 2e-4, 2e-5)[0]
            kernel_vs_plain(f"fleet_f64_B{FLEET_B}_T{T}_L4", *pendulum_inputs(FLEET_B, torch.float64), 4,
                            1e-10, 1e-10)  # fmt: skip
            out["fleet"] = dict(time_ladder(card, "n2m1e1", fleet_in, 4, (T, 2, 1, 1, FLEET_B)),
                                max_abs_err=err32, p50_ms=float(np.percentile(ms, 50)),
                                p99_ms=float(np.percentile(ms, 99)), launches_per_replan=f["launches"][0],
                                budget_ms=FLEET_BUDGET_MS)  # fmt: skip
            say("mesh_fleet_replan", card=f"'{card}'", world=1, B=FLEET_B, T=T, iters=FLEET.max_iterations,
                replans=FLEET_REPLANS, p50_ms=f"{out['fleet']['p50_ms']:.2f}",
                p99_ms=f"{out['fleet']['p99_ms']:.2f}", min_ms=f"{ms.min():.2f}", budget_ms=FLEET_BUDGET_MS,
                within_budget=bool(out["fleet"]["p99_ms"] <= FLEET_BUDGET_MS), launches_per_replan=f["launches"],
                mean_constr_first=f"{f['mean_constr'][0]:.3e}", mean_constr_last=f"{f['mean_constr'][-1]:.3e}")  # fmt: skip
        finally:
            dist.destroy_process_group()
        t_a = time.perf_counter() - t0

        # (b) two gloo ranks on the one card
        (Path(d) / "split").mkdir()
        torch.multiprocessing.spawn(mesh_rank, args=(2, f"{d}/split/store", f"{d}/split"), nprocs=2)
        ranks = [torch.load(Path(d) / "split" / f"rank{r}.pt") for r in range(2)]
    out["split"] = split_checks(whole, ranks)
    say("mesh_split", card=f"'{card}'", world=2, backend="gloo", device="cuda:0 for both ranks",
        launches_headline=[r["headline_float32"]["launches"] for r in ranks],
        fleet_launches=[r["fleet_float32"]["launches"] for r in ranks],
        **{k: (f"{v:.4f}" if "float32" in k else f"{v:.3e}") for k, v in out["split"].items()})  # fmt: skip
    # (c)
    say("mesh", target="'BASELINE configs[4]: 32k scenarios across N>=2 hosts over NCCL'", verified=False,
        reason="'one card: world size 1 over NCCL, 2 gloo ranks sharing cuda:0; NCCL across cards unverified'")  # fmt: skip
    say("phase13", wall_s=f"{time.perf_counter() - t0:.1f}", a_s=f"{t_a:.1f}")
    return out


# ----------------------------------------- give_up_after and the examples


def lanes_that_may_give_up(history):
    """Lanes whose streak may have reached GIVE_UP: a run of GIVE_UP zero
    steps, or of GIVE_UP − 1 from row 0 (the pre-loop's step is not
    recorded).  Every other lane never gave up."""
    zero = (history.step == 0).cpu().numpy()
    out = set()
    for lane in range(zero.shape[1]):
        run = 0
        for row in range(zero.shape[0]):
            run = run + 1 if zero[row, lane] else 0
            if run >= GIVE_UP or run == row + 1 == GIVE_UP - 1:
                out.add(lane)
    return out


def racing_solve(problem, x0s, us0, mu0, give_up_after):
    """One solve of phase 14a through #2 and #1, its launches checked
    against phase 5's; returns (result, wall s, the line search's
    rollouts)."""
    from ddp_tpu_torch.solver import batched

    rollout, steps = batched.feedback_rollout, []

    def counted(*args):
        steps.append(args[-1])
        return rollout(*args)

    batched.feedback_rollout = counted
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve_batched(problem, ARM, x0s, us_init=us0, deriv="kernel", backward="kernel", mu_init=mu0,
                            give_up_after=give_up_after, history=True, **ARM_KW)  # fmt: skip
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        batched.feedback_rollout = rollout
    fd_expected, rs_expected = 1 + ARM.max_iterations + 1, 1 + ARM.max_iterations
    check(fd.LAUNCHES == fd_expected and rs.LAUNCHES == rs_expected
          and rs.LEVELS_SWEPT == rs_expected * ARM_REG_LEVELS,
          f"racing fleet give_up_after={give_up_after}: launches fd {fd.LAUNCHES}, riccati {rs.LAUNCHES} "
          f"sweeping {rs.LEVELS_SWEPT}")  # fmt: skip
    return res, wall, len(steps)


def racing_fleet(card, problem, x0s, us0):
    """Phase 14a: phase 5's arm fleet (f32, #2 and #1) with the lanes RACERS
    at μ = ∞, solved with give_up_after None and GIVE_UP in turns (none,
    give-up, none; history on): the lanes that never gave up bit for
    bit the same, or no further apart than the two solves without give-up;
    the racers at μ = ∞ with every step 0, finite controls and their reg
    constant from the row they froze; the launches of every solve phase 5's.
    Returns the launches, rollouts, wall times and feasible shares."""
    mu0 = torch.full((ARM_B,), ARM.mu, dtype=torch.float32, device=DEV)
    mu0[list(RACERS)] = torch.inf
    runs = {None: [], GIVE_UP: []}
    for g in (None, GIVE_UP, None):
        runs[g].append(racing_solve(problem, x0s, us0, mu0, g))
    (base, _, rollouts_none), (rep, _, _) = runs[None]
    gu, _, rollouts_gu = runs[GIVE_UP][0]
    others = [lane for lane in range(ARM_B) if lane not in RACERS]
    kept = sorted(set(others) - lanes_that_may_give_up(gu.history))

    def spread(a, b):
        return max(float((getattr(a, f)[kept] - getattr(b, f)[kept]).abs().max())
                   for f in ("xs", "us", "mu", "reg", "opt_constr"))  # fmt: skip

    diff, bar = spread(gu, base), spread(rep, base)  # the card's run-to-run spread is the bar
    check(diff <= bar, f"racing fleet: the lanes that never gave up differ by {diff:.3e} (repeat's {bar:.3e})")
    r = list(RACERS)
    check(bool(torch.isinf(gu.mu[r]).all()) and bool(torch.isinf(base.mu[r]).all()), "racers: μ not ∞")
    check(bool((gu.history.step[:, r] == 0).all()) and bool((base.history.step[:, r] == 0).all()),
          "racers: a step was accepted")  # fmt: skip
    check(bool(torch.isfinite(gu.us[r]).all()), "racers: non-finite controls")
    # the pre-loop and rows 0 … GIVE_UP − 2 at step 0: dead from row GIVE_UP − 1
    freeze = GIVE_UP - 1
    reg = gu.history.reg[:, r]
    check(bool((reg[freeze:] == reg[freeze - 1]).all()), "racers: reg moved after they froze")
    walls = {g: [w for _, w, _ in runs[g]] for g in runs}
    share = {g: float((runs[g][0][0].opt_constr[others] < 1e-2).float().mean()) for g in runs}
    same = int((gu.us[others] == base.us[others]).flatten(1).all(dim=1).sum())
    out = dict(launches=dict(fd=fd.LAUNCHES, riccati=rs.LAUNCHES, levels_swept=rs.LEVELS_SWEPT),
               rollouts=dict(none=rollouts_none, give_up=rollouts_gu),
               wall_s=dict(none=walls[None], give_up=walls[GIVE_UP]),
               give_up_over_none=statistics.mean(walls[GIVE_UP]) / statistics.mean(walls[None]),
               lanes_compared=len(kept),
               lanes_bitwise_of_others=same, max_diff=diff, repeat_spread=bar,
               frac_main=dict(none=share[None], give_up=share[GIVE_UP]))  # fmt: skip
    say("give_up_arm_fleet", card=f"'{card}'", B=ARM_B, H=ARM_H, iters=ARM.max_iterations, racers=r,
        give_up_after=GIVE_UP, launches_each=out["launches"], rollouts=out["rollouts"],
        wall_s_none=[f"{w:.3f}" for w in walls[None]], wall_s_give_up=[f"{w:.3f}" for w in walls[GIVE_UP]],
        give_up_over_none=f"{out['give_up_over_none']:.4f}", lanes_never_gave_up=len(kept),
        max_diff=f"{diff:.3e}", repeat_spread=f"{bar:.3e}", others_bitwise=f"{same}/{len(others)}",
        frac_main_others_none=share[None], frac_main_others_give_up=share[GIVE_UP])  # fmt: skip
    return out


def give_up_pendulum():
    """Phase 14b: ddp_tpu's own give-up case (4 pendulums, T = 100, lane 0 at
    μ = ∞, f64) through the Riccati kernel and the sweep: the healthy lanes
    within 1e-8 of each lane's largest |u|, lane 0 at μ = ∞ with finite
    controls, 1 + 12 launches of #1 on the kernel route; and the two
    ValueErrors.  Returns #1's launches."""
    problem = pendulum_problem(GU_PEND_H, torch.float64)
    x0s = torch.tensor([[q, 0.0] for q in GU_PEND_Q0], dtype=torch.float64, device=DEV)
    mu0 = torch.tensor([torch.inf] + [GU_PEND.mu] * 3, dtype=torch.float64, device=DEV)
    res = {}
    for backward in ("kernel", "sweep"):
        reset_launch_counts()
        res[backward] = solve_batched(problem, GU_PEND, x0s, forward="seq", backward=backward, mu_init=mu0,
                                      give_up_after=GIVE_UP)  # fmt: skip
        torch.cuda.synchronize()
        if backward == "kernel":
            launches = rs.LAUNCHES
            check(launches == 1 + GU_PEND.max_iterations, f"give-up pendulum: #1 launches {launches}")
    k, sw = res["kernel"], res["sweep"]
    err = float(((k.us[1:] - sw.us[1:]).abs().amax(dim=(1, 2))
                 / sw.us[1:].abs().amax(dim=(1, 2)).clamp(min=1.0)).max())  # fmt: skip
    check(err <= 1e-8, f"give-up pendulum: kernel vs sweep {err:.3e} of the lanes' |u|")
    for r in (k, sw):
        check(bool(torch.isinf(r.mu[0])) and bool(torch.isfinite(r.us[0]).all()), "give-up pendulum: lane 0")
    raised = []
    for kw in (dict(forward="sweep", give_up_after=GIVE_UP), dict(forward="seq", give_up_after=0)):
        try:
            solve_batched(problem, GU_PEND, x0s, **kw)
        except ValueError as e:
            raised.append("give_up_after" in str(e))
    check(raised == [True, True], f"give_up_after's ValueErrors: {raised}")
    say("give_up_pendulum", T=GU_PEND_H, iters=GU_PEND.max_iterations, riccati_launches=launches,
        kernel_vs_sweep_scaled=f"{err:.3e}", bar=1e-8, value_errors=2)  # fmt: skip
    return launches


def run_example(name, **kw):
    """``main(device=DEV, **kw)`` of examples/<name>.py, its printed lines
    echoed; returns (its result, the wall seconds)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main(device=DEV, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"  {name}| {line}", flush=True)
    return out, wall


def examples_path(card):
    """Phase 14c: the three examples at full size on the card, held to what
    ddp_tpu's examples give on the CPU: the pendulum swing-up in f32 (|eq| <
    1e-2) and f64 (the same converged flag, final q within 1e-6, |eq| ≤ 10×);
    UR5's reach in f64 (the reached position within 1e-6 m, |eq| ≤ 10×);
    the fleet at B = 512 (finite u0, 1 + 6 launches of #1 a replan, mean
    |eq| ≤ 10×).  Returns the walls, #1's launches and the fleet's times."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        res, wall = run_example("torch_pendulum_swingup", dtype=dtype)
        ref, tag = PEND_JAX_CPU[dtype], str(dtype)[6:]
        q, eq = float(res.xs[-1, 0]), float(res.stats.opt_constr)
        if dtype == torch.float64:
            check(bool(res.stats.converged) == ref["converged"], f"pendulum f64: converged {bool(res.stats.converged)}")
            check(abs(q - ref["q"]) <= 1e-6, f"pendulum f64: final q {q!r}")
            check(eq <= 10 * ref["eq"], f"pendulum f64: |eq| {eq:.3e} against ddp_tpu's {ref['eq']:.3e}")
        else:
            check(eq < 1e-2, f"pendulum f32: |eq| {eq:.3e}")
        out["pendulum_" + tag] = dict(wall_s=wall, iterations=int(res.stats.iterations), eq=eq)
        say("example_pendulum_swingup", card=f"'{card}'", dtype=tag, converged=bool(res.stats.converged),
            iters=int(res.stats.iterations), final_q=f"{q:.10f}", eq=f"{eq:.3e}",
            ddp_tpu_cpu=f"'{ref['converged']} {ref['iterations']} {ref['q']!r} {ref['eq']:.3e}'",
            wall_s=f"{wall:.3f}", s_per_iteration=f"{wall / int(res.stats.iterations):.4f}")  # fmt: skip
    (res, _, reached), wall = run_example("torch_ur5_reach")
    d = float((reached - torch.tensor(UR5_JAX_CPU["reached"], dtype=torch.float64)).abs().max())
    eq = float(res.stats.opt_constr)
    check(d <= 1e-6, f"UR5 reach: reached position {d:.3e} m from ddp_tpu's")
    check(eq <= 10 * UR5_JAX_CPU["eq"], f"UR5 reach: |eq| {eq:.3e} against ddp_tpu's {UR5_JAX_CPU['eq']:.3e}")
    out["ur5"] = dict(wall_s=wall, iterations=int(res.stats.iterations), eq=eq, reached_diff_m=d)
    say("example_ur5_reach", card=f"'{card}'", dtype="float64", iters=int(res.stats.iterations),
        ddp_tpu_iters=UR5_JAX_CPU["iterations"], reached_diff_m=f"{d:.3e}", eq=f"{eq:.3e}",
        ddp_tpu_eq=f"{UR5_JAX_CPU['eq']:.3e}", wall_s=f"{wall:.3f}")  # fmt: skip
    reset_launch_counts()
    fleet, wall = run_example("torch_mpc_fleet")
    launches = rs.LAUNCHES
    per_replan = 1 + 6  # the pre-loop backward and one an iteration
    check(launches == fleet["replans"] * per_replan, f"fleet example: #1 launches {launches} for {fleet['replans']}")
    check(bool(torch.isfinite(fleet["u0"]).all()), "fleet example: non-finite u0")
    check(fleet["mean_constr"] <= 10 * FLEET_JAX_CPU_MEAN_EQ,
          f"fleet example: mean |eq| {fleet['mean_constr']:.3e} against ddp_tpu's {FLEET_JAX_CPU_MEAN_EQ:.3e}")  # fmt: skip
    out["fleet"] = dict(wall_s=wall, launches=launches, replans=fleet["replans"], B=fleet["B"],
                        ms_blocking=1e3 * fleet["s_blocking"], ms_back_to_back=1e3 * fleet["s_sustained"],
                        mean_constr=fleet["mean_constr"])  # fmt: skip
    say("example_mpc_fleet", card=f"'{card}'", B=fleet["B"], world=fleet["n_devices"], replans=fleet["replans"],
        riccati_launches=launches, per_replan=per_replan, ms_per_replan_blocking=f"{out['fleet']['ms_blocking']:.3f}",
        ms_per_replan_back_to_back=f"{out['fleet']['ms_back_to_back']:.3f}",
        mean_eq=f"{fleet['mean_constr']:.3e}", ddp_tpu_mean_eq=f"{FLEET_JAX_CPU_MEAN_EQ:.3e}", wall_s=f"{wall:.3f}")  # fmt: skip
    return out


def give_up_and_examples(card, arm):
    """Phase 14: give_up_after on the racing arm fleet (a) and on ddp_tpu's
    own case (b), and the three examples (c)."""
    t0 = time.perf_counter()
    out = dict(a=racing_fleet(card, *arm), b=give_up_pendulum())
    t_ab = time.perf_counter() - t0
    out["c"] = examples_path(card)
    say("phase14", wall_s=f"{time.perf_counter() - t0:.1f}", ab_s=f"{t_ab:.1f}")
    return out


# ------------------------------------------- phase 15: BASELINE configs[2]


def double_pendulum_problem(dtype):
    """benchmarks/double_pendulum_reach.py's problem from the port's
    constructors: Euler double pendulum (dt = 0.01), ½‖u‖², q = (0.8, −0.5)
    at H = 32, advanced twice, Gauss-Newton."""
    kw = dict(dtype=dtype, device=DEV)
    model = double_pendulum(**kw)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(model, torch.tensor(DP_TARGET, **kw), (DP_H,)), dyn, times=2
    )
    return Problem(dyn, costs.quad_control(1.0, **kw), con, DP_H, second_order=False)


def double_pendulum_x0s(dtype, Bk):
    """The recipe's draw from default_rng(0) for its 2048 lanes (q ~ U(−0.3,
    0.3), v ~ 0.2·N(0, 1)), the first ``Bk`` of them."""
    rng = np.random.default_rng(0)
    x0 = np.concatenate([rng.uniform(-0.3, 0.3, (DP_B, 2)), 0.2 * rng.standard_normal((DP_B, 2))], axis=1)
    return torch.tensor(x0[:Bk], dtype=dtype, device=DEV)


def double_pendulum_solve(dtype, Bk, deriv, backward, params=DP):
    """One solve of the recipe, its launches and its wall seconds."""
    problem, x0s = double_pendulum_problem(dtype), double_pendulum_x0s(dtype, Bk)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_batched(problem, params, x0s, deriv=deriv, backward=backward, **DP_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return problem, res, dict(launch_counts(), levels_swept=rs.LEVELS_SWEPT), wall


def double_pendulum_first_inputs(dtype):
    """What the path's first backward call gives #1: the derivatives along
    the rollout of zero controls from the recipe's x0s, the initial
    multipliers, μ0 and reg 0."""
    problem, x0s = double_pendulum_problem(dtype), double_pendulum_x0s(dtype, DP_B)
    us = torch.zeros(DP_B, DP_H, problem.nu, dtype=dtype, device=DEV)
    xs = problem.rollout(x0s, us)
    mults = al.init_multipliers(problem, xs)
    kw = dict(dtype=dtype, device=DEV)
    mu, reg = torch.full((DP_B,), DP.mu, **kw), torch.zeros(DP_B, **kw)
    return (problem.derivatives(xs, us), mults.val, mults.jac), mu, reg


def kernel_vs_other_order(name, inputs, mu, reg, n_levels):
    """Kernel #1 in f64 on inputs its gains are ill-conditioned on (a
    finished solve's at μ up to 1e11, where another summation order, the
    batched sweep ladder ``_backward_multi_reg``, lands 1.1e-8 of the
    largest k from the plain f64 version on the CPU): ok and reg_used equal
    to the plain f64 version's, and k, K within 1e-6 of each array's largest
    entry, 100× what that order shows and far below what a wrong index
    gives; the other order's distance is reported beside the kernel's.
    Returns both distances."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    before = rs.LAUNCHES
    got = rs.backward_ladder(*inputs, mu, levels)
    torch.cuda.synchronize()
    check(rs.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel once")
    ref = rs.backward_ladder_reference(*inputs, mu, levels)
    other = _backward_multi_reg(*inputs, mu, reg, n_levels)
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    check(torch.equal(got[3], ref[3]), f"{name}: reg_used differs")
    keep = ref[2] & other[2]
    dist = {}
    for i, label in enumerate(("k", "K")):
        scale = float(ref[i][keep].abs().max())
        k_err = float((got[i][keep] - ref[i][keep]).abs().max()) / scale
        o_err = float((other[i][keep] - ref[i][keep]).abs().max()) / scale
        check(k_err <= 1e-6, f"{name}: {label} {k_err:.3e} of its largest entry from plain, another order {o_err:.3e}")
        dist[label] = (k_err, o_err)
    say("kernel", case=name, levels=n_levels, **{f"{lb}_rel_from_plain_kernel": f"{k:.3e}" for lb, (k, _) in dist.items()},
        **{f"{lb}_rel_from_plain_other_order": f"{o:.3e}" for lb, (_, o) in dist.items()}, bar=1e-6,
        ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}")  # fmt: skip
    return dict(kernel_rel_from_plain=max(k for k, _ in dist.values()),
                other_order_rel_from_plain=max(o for _, o in dist.values()))


def kernel_f32_unresolved(name, inputs, mu, reg, n_levels):
    """Kernel #1 in f32 on inputs where float32 resolves neither the gains
    nor every lane's level (a finished solve's at μ up to 1e11: the AL terms
    of Quu and Qu cancel to roundoff of μ-sized sums).  Two f32 orders, the
    plain version and the batched sweep ladder (``_backward_multi_reg``),
    put some lanes on other levels, and each f32 order's gains lie 1e2-1e4
    from float64's on gains of at most ~1e3, as far as roundoff happens to
    carry that order: no bar on the gains tells a fault from a draw there,
    so they are reported (each order's largest distance from the plain f64
    version on f64 copies, over the lanes all take at the same level) and
    phase 15a holds the gains in f64 on the same inputs and in f32 on the
    first call's.  Held: ok equal to the plain f32 version's, finite gains
    on the lanes some level saved, and at most twice as many lanes on
    another level than the plain version's as the other order has (at least
    one).  Returns the counts and distances."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    before = rs.LAUNCHES
    got = rs.backward_ladder(*inputs, mu, levels)
    torch.cuda.synchronize()
    check(rs.LAUNCHES == before + 1, f"{name}: the wrapper did not launch its kernel once")
    ref = rs.backward_ladder_reference(*inputs, mu, levels)
    other = _backward_multi_reg(*inputs, mu, reg, n_levels)
    wide = (precise.wide(inputs[0]), inputs[1].double(), inputs[2].double())
    truth = rs.backward_ladder_reference(*wide, mu.double(), levels.double())
    check(torch.equal(got[2], ref[2]), f"{name}: ok vectors differ")
    check(all(bool(torch.isfinite(x[got[2]]).all()) for x in got[:2]), f"{name}: non-finite gains")
    moved, moved_other = int((got[3] != ref[3]).sum()), int((other[3] != ref[3]).sum())
    check(moved <= max(2 * moved_other, 1),
          f"{name}: {moved} lanes on another level than the plain version's, another order {moved_other}")  # fmt: skip
    keep = (got[3] == ref[3]) & (other[3] == ref[3]) & (ref[3].double() == truth[3]) & ref[2] & truth[2]
    dist = {label: {who: float((x[i][keep].double() - truth[i][keep]).abs().max())
                    for who, x in (("kernel", got), ("plain", ref), ("other_order", other))}
            for i, label in enumerate(("k", "K"))}  # fmt: skip
    say("kernel", case=name, levels=n_levels, lanes_other_level=moved, lanes_other_level_other_order=moved_other,
        lanes_compared=int(keep.sum()), **{f"{lb}_from_f64": {k: f"{v:.3e}" for k, v in d.items()} for lb, d in dist.items()},
        f64_largest_k=f"{float(truth[0].abs().max()):.3e}", ok_lanes=f"{int(got[2].sum())}/{got[2].numel()}")  # fmt: skip
    return dict(lanes_other_level=moved, lanes_other_level_other_order=moved_other, from_f64=dist)


def three_link(dtype):
    """A three-revolute arm (axes y, x, y; 0.4 m links, centres of mass
    mid-link, damped), the joint count no robot of the zoo has
    (tests/test_torch_kernels_on_host.py's)."""
    joints = [
        dict(type="revolute", parent=i - 1, axis=axis, placement_trans=[0.0, 0.0, 0.4 * (i > 0)],
             mass=1.0 - 0.2 * i, com=[0.0, 0.0, 0.2], inertia=np.diag([0.02, 0.02, 0.005]))
        for i, axis in enumerate(([0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    ]  # fmt: skip
    model = build_model(joints, name="three_link", device=DEV, dtype=dtype)
    model.damping = torch.full((3,), 0.05, device=DEV, dtype=dtype)
    return model


def double_pendulum_path(card):
    """Phase 15: BASELINE configs[2] at full size through #2 (nv = 2) and #1
    at (4, 2, 2) Gauss-Newton, the shapes no library had before this phase:
    (15c) the recipe through the kernel route with exact launch counts and
    the feasible share against ddp_tpu's on the CPU, through jvp/sweep, and
    both routes in f64 at 64 lanes; (15a) #1 at (4, 2, 2) against its plain
    version on the kernel route's finished inputs in f32 and f64, timed, and
    at (6, 3, 3) both orders and (12, 6, 12) second order on seeded SPD
    inputs; (15b) #2 and #3 at nv = 3 and #2 on the double pendulum at
    N = B·H, against their plain versions, #2 timed."""
    t0 = time.perf_counter()
    out = {}
    # 15c: the recipe on both routes
    p32, res_k, c_k, wall_k = double_pendulum_solve(torch.float32, DP_B, "kernel", "kernel")
    n_bwd = 1 + DP.max_iterations
    expect = dict(riccati=n_bwd, fd=2 + DP.max_iterations, fd2=0, linesearch=0, flat_solve=0,
                  levels_swept=n_bwd * DP_REG_LEVELS)  # fmt: skip
    check(c_k == expect, f"double pendulum launches {c_k} != {expect}")
    for name in RESULT_FIELDS:
        check(bool(torch.isfinite(getattr(res_k, name)).all()), f"double pendulum: non-finite {name}")
    check(res_k.us.shape == (DP_B, DP_H, 2) and res_k.xs.shape == (DP_B, DP_H + 1, 4),
          "double pendulum: result shapes")  # fmt: skip
    frac_k = float((res_k.opt_constr < 1e-2).float().mean())
    check(frac_k >= DP_JAX_CPU_SHARE - 0.01,
          f"double pendulum share {frac_k} below ddp_tpu's {DP_JAX_CPU_SHARE} - 0.01")  # fmt: skip
    _, res_j, c_j, wall_j = double_pendulum_solve(torch.float32, DP_B, "jvp", "sweep")
    # solves/s of the kernel route after its checked solve (the first solve
    # of the run at these shapes pays the allocator's and libraries' warm-up)
    wall_k_first = wall_k
    _, res_k2, c_k2, wall_k = double_pendulum_solve(torch.float32, DP_B, "kernel", "kernel")
    check(c_k2 == expect and torch.equal(res_k2.us, res_k.us), "double pendulum: a second kernel solve differs")
    check(sum(v for k, v in c_j.items() if k != "levels_swept") == 0,
          f"a kernel ran on the jvp/sweep route: {c_j}")  # fmt: skip
    frac_j = float((res_j.opt_constr < 1e-2).float().mean())
    _, r64_k, _, _ = double_pendulum_solve(torch.float64, DP_B64, "kernel", "kernel", DP64)
    _, r64_j, _, _ = double_pendulum_solve(torch.float64, DP_B64, "jvp", "sweep", DP64)
    err64 = lane_scaled_err(r64_k, r64_j)
    check(err64 <= 1e-7, f"double pendulum f64 us max scaled err {err64}")
    check(torch.equal(r64_k.mu, r64_j.mu), "double pendulum f64: per-lane mu differs")
    out["path"] = dict(
        launch_counts=c_k, feasible_kernel=frac_k, feasible_jvp_sweep=frac_j,
        feasible_ddp_tpu_cpu=DP_JAX_CPU_SHARE, solves_per_s_kernel=DP_B / wall_k,
        solves_per_s_jvp_sweep=DP_B / wall_j, f64_us_max_scaled_err=err64,
    )  # fmt: skip
    say("double_pendulum", card=f"'{card}'", B=DP_B, H=DP_H, iters=DP.max_iterations, launches=c_k,
        frac_kernel=frac_k, frac_jvp_sweep=frac_j, frac_ddp_tpu_cpu=DP_JAX_CPU_SHARE,
        p99_eq=f"{float(torch.quantile(res_k.opt_constr, 0.99)):.3e}",
        mu_equal_routes=float((res_k.mu == res_j.mu).float().mean()),
        solve_s_kernel=f"{wall_k:.3f}", solve_s_kernel_first=f"{wall_k_first:.3f}",
        solve_s_jvp_sweep=f"{wall_j:.3f}",
        solves_per_s_kernel=f"{DP_B / wall_k:.1f}", solves_per_s_jvp_sweep=f"{DP_B / wall_j:.1f}",
        f64_B=DP_B64, f64_us_max_scaled_err=f"{err64:.3e}", f64_mu_identical=True)  # fmt: skip

    # 15a: #1 at (4, 2, 2) on the inputs of the path's first backward call
    # (the initial rollout, μ0, zero multipliers) at phase 3's bars, and on
    # its last call's (the finished solve's, μ up to 1e11), where no float32
    # order resolves the gains: f64 copies held to the plain f64 version at
    # a bar 100× another order's distance, f32 to what f32 resolves there
    err32 = kernel_vs_plain(f"dp_first_call_f32_B{DP_B}_T{DP_H}", *double_pendulum_first_inputs(torch.float32),
                            DP_REG_LEVELS, 2e-3, 2e-4)[0]  # fmt: skip
    err64k = kernel_vs_plain(f"dp_first_call_f64_B{DP_B}_T{DP_H}", *double_pendulum_first_inputs(torch.float64),
                             DP_REG_LEVELS, 1e-9, 1e-9)[0]  # fmt: skip
    inputs, mu, reg = finished_inputs(p32, res_k)
    fin32 = kernel_f32_unresolved(f"dp_finished_f32_B{DP_B}_T{DP_H}", inputs, mu, reg, DP_REG_LEVELS)
    wide = ((precise.wide(inputs[0]), inputs[1].double(), inputs[2].double()), mu.double(), reg.double())
    fin64 = kernel_vs_other_order(f"dp_finished_f64_B{DP_B}_T{DP_H}", *wide, DP_REG_LEVELS)
    for so, dims, Bk, Tk in ((False, (6, 3, 3), 1000, 16), (True, (6, 3, 3), 1000, 16),
                             (True, (12, 6, 12), QUAD_B, QUAD_H)):  # fmt: skip
        label = f"{'so_' if so else ''}n{dims[0]}m{dims[1]}e{dims[2]}_B{Bk}_T{Tk}"
        kernel_vs_plain(label + "_f64", *spd_inputs(Bk, Tk, *dims, torch.float64, so), DP_REG_LEVELS,
                        1e-9, 1e-9, so)  # fmt: skip
        kernel_vs_plain(label + "_f32", *spd_inputs(Bk, Tk, *dims, torch.float32, so), DP_REG_LEVELS,
                        2e-3, 2e-4, so)  # fmt: skip
    ladder = time_ladder(card, "n4m2e2", (inputs, mu, reg), DP_REG_LEVELS, (DP_H, 4, 2, 2, DP_B))
    plan = rs.plan_launch(*inputs, mu, torch.stack(_reg_levels(mu, reg, DP_REG_LEVELS)))
    ladder["device_ms"] = device_ms(lambda: rs.launch_plan(plan))
    ladder["f64_ms"] = event_ms(lambda: rs.backward_ladder(*wide[0], wide[1],
                                                           torch.stack(_reg_levels(*wide[1:], DP_REG_LEVELS))))
    say("time_backward_device", card=f"'{card}'", shape=f"n4m2e2_T{DP_H}_B{DP_B}_L{DP_REG_LEVELS}",
        device_ms_f32=f"{ladder['device_ms']:.4f}",
        device_over_bound=f"{ladder['device_ms'] / ladder['bound_ms']:.1f}",
        wrapper_call_f64_ms=f"{ladder['f64_ms']:.4f}")  # fmt: skip
    out["riccati"] = dict(ladder, shape=f"n4m2e2_T{DP_H}_B{DP_B}_L{DP_REG_LEVELS}_f32",
                          launches=c_k["riccati"], levels_swept=c_k["levels_swept"],
                          max_abs_err=err32, f64_max_abs_err=err64k,
                          finished_f32=fin32, finished_f64=fin64)  # fmt: skip

    # 15b: #2 and #3 at nv = 3, #2 at the recipe's N = B·H on its model
    t32, t64 = three_link(torch.float32), three_link(torch.float64)
    fd_kernel_vs_plain("three_link_f32_N4096", t32, 4096, torch.float32, t64)
    fd_kernel_vs_plain("three_link_f64_N4096", t64, 4096, torch.float64)
    fd_kernel_vs_plain("fd2_three_link_f32_N4096", t32, 4096, torch.float32, t64, second=True)
    fd_kernel_vs_plain("fd2_three_link_f64_N1000", t64, 1000, torch.float64, second=True)
    dp32, dp64 = double_pendulum(device=DEV, dtype=torch.float32), double_pendulum(device=DEV, dtype=torch.float64)
    N = DP_B * DP_H
    fd_err32, fd_in = fd_kernel_vs_plain(f"double_pendulum_f32_N{N}", dp32, N, torch.float32, dp64)
    fd_kernel_vs_plain(f"double_pendulum_f64_N{N}", dp64, N, torch.float64)
    fd_f64_in = tuple(x.double() for x in fd_in)
    fdt = dict(ms=event_ms(lambda: fd.fd_derivs(dp32, *fd_in)),
               plain_ms=event_ms(lambda: fd.fd_derivs_reference(dp32, *fd_in), reps=5),
               f64_ms=event_ms(lambda: fd.fd_derivs(dp64, *fd_f64_in)))  # fmt: skip
    fdt["bound_ms"], fdt["bound_by"] = fd_bound_ms(dp32, N)
    say("time_fd_derivs", card=f"'{card}'", shape=f"double_pendulum_N{N}_f32", kernel_ms=f"{fdt['ms']:.4f}",
        plain_ms=f"{fdt['plain_ms']:.4f}", bound_ms=f"{fdt['bound_ms']:.5f}", bound_by=fdt["bound_by"],
        kernel_over_bound=f"{fdt['ms'] / fdt['bound_ms']:.1f}", kernel_f64_ms=f"{fdt['f64_ms']:.4f}")  # fmt: skip
    out["fd"] = dict(fdt, shape=f"double_pendulum_N{N}_f32", launches=c_k["fd"], max_abs_err=fd_err32)
    say("phase15", wall_s=f"{time.perf_counter() - t0:.1f}")
    return out


# ------------------------------------------- phase 16: the flat-lane class


def flat_class_times(card, name, problem, state, fs_plain_s):
    """#4 (f32, 4 candidates) on a class's line-search state and, where #5
    takes the class, #5 on its headline-sized solve: the kernel on a launch
    plan by events and by device time alone, the plain version, the bound
    recounted for the class."""
    n_ls = HEADLINE_KW["n_linesearch"]
    ops = flat_ops(problem)
    plan = lsf.plan_launch(problem, *state, n_ls)
    ls = dict(ms=event_ms(lambda: lsf.launch_plan(plan)), device_ms=device_ms(lambda: lsf.launch_plan(plan)),
              plain_ms=event_ms(lambda: lsf.linesearch_reference(problem, *state, n_ls), reps=3))  # fmt: skip
    ls["bound_ms"], ls["bound_by"] = linesearch_bound_ms(T, 2, 1, problem.ne, B, n_ls, ops)
    out = dict(linesearch=ls)
    line = dict(ls_ms=f"{ls['ms']:.4f}", ls_device_ms=f"{ls['device_ms']:.4f}",
                ls_plain_ms=f"{ls['plain_ms']:.3f}", ls_bound_ms=f"{ls['bound_ms']:.5f}",
                ls_bound_by=ls["bound_by"], ls_plan=plan.geometry)  # fmt: skip
    if fs_plain_s is not None:
        x32 = headline_x0s(torch.float32)
        fplan = fs.plan_launch(problem, HEADLINE, x32, n_linesearch=n_ls)
        f = dict(ms=event_ms(lambda: fs.launch_plan(fplan), reps=5), plain_ms=1e3 * fs_plain_s,
                 plan=dict(fplan.geometry))  # fmt: skip
        f["bound_ms"], f["bound_by"] = flat_solve_bound_ms(T, 2, 1, problem.ne, B, HEADLINE.max_iterations,
                                                           n_ls, ops)  # fmt: skip
        out["flat_solve"] = f
        line.update(fs_ms=f"{f['ms']:.4f}", fs_plain_ms=f"{f['plain_ms']:.1f}", fs_bound_ms=f"{f['bound_ms']:.5f}",
                    fs_bound_by=f["bound_by"], fs_plan=fplan.geometry)  # fmt: skip
    say("time_flat_class", card=f"'{card}'", case=f"{name}_T{T}_B{B}_C{n_ls}_f32", **line)
    return out


def flat_route(problem, params, x0s, route, n_ls=4):
    """One solve of a flat-lane problem by route ("sweep": solve_batched's
    sweep backward and parallel line search; "A": forward="kernel",
    backward="kernel"; "B": solve_flat), its launches counted from 0 and its
    wall seconds to a synchronize.  Returns (result, counts, wall s)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    if route == "B":
        res = fs.solve_flat(problem, params, x0s, n_linesearch=n_ls)
    else:
        kw = dict(backward="kernel", forward="kernel") if route == "A" else dict(backward="sweep")
        res = solve_batched(problem, params, x0s, n_reg_levels=1, n_linesearch=n_ls, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, dict(launch_counts(), levels_swept=rs.LEVELS_SWEPT), wall


def flat_classes_path(card):
    """Phase 16: #4 and #5 over the flat-lane class.  (a) Each class of
    ``flat_class_spec`` against the plain versions at B = 4096, T = 32 in f64
    and f32 (#4 at phase 3's bars; #5 where it takes the class, at phase 3's,
    and its "single-active-step" refusal where it does not), each timed; #4
    and #5 at the fleet's shapes too (T = 100; #5 at 8 iterations); #1 at the
    new Gauss-Newton shapes (2, 1, 2) and (2, 1, 3) against its plain
    version and timed.  (b) The arrive-at-rest fleet through the sweep route,
    path A (31 + 31 launches) and path B (1 launch): the feasible share
    against ddp_tpu's on the CPU less 0.01, f32 lane agreement with the sweep
    route against the reference's own agreement less 0.02 (below zero: it
    holds nothing), f64 at 64 lanes and 8 iterations within 1e-8 of each
    lane's |u| with identical μ, and f32 at 8 iterations (9 + 9 launches on
    path A) held to (a)'s plain float64 solve as closely as the sweep route.
    (c) The RK4 tracking twin through path B against the sweep route, f32
    and f64.  Returns the numbers of the kernels' JSON."""
    t0 = time.perf_counter()
    f64, f32 = torch.float64, torch.float32
    out = dict(classes={}, riccati={})
    # 16a: every class, both kernels against their plain versions
    for name in FLAT_CLASSES:
        spec = flat_class_spec(name, T)
        for n_cand in (4, 7) if name == "state" else (4,):
            linesearch_vs_plain(f"ls_{name}_f64_B{B}_T{T}_C{n_cand}",
                                *linesearch_inputs(B, f64, Tk=T, spec=spec), n_cand, 1e-10, 1.0)  # fmt: skip
        if name == "in_range":  # the state target behind a layer of other dynamics: f64 only
            flat_solve_vs_plain(f"fs_{name}_f64_B{B}_T{T}", f64, B, spec=spec, resolution=True)
            continue
        p32, s32 = linesearch_inputs(B, f32, Tk=T, spec=spec)
        ls_err, _ = linesearch_vs_plain(f"ls_{name}_f32_B{B}_T{T}_C4", p32, s32, 4, 2e-5, 0.99)
        fs_err = fs_plain_s = None
        if name in FS_CLASSES:
            flat_solve_vs_plain(f"fs_{name}_f64_B{B}_T{T}", f64, B, spec=spec, resolution=True)
            fs_err, fs_plain_s, _ = flat_solve_vs_plain(f"fs_{name}_f32_B{B}_T{T}", f32, B, spec=spec,
                                                     resolution=True)  # fmt: skip
        else:
            try:
                fs.solve_flat(p32, HEADLINE, headline_x0s(f32))
            except ValueError as exc:
                check("single-active-step" in str(exc), f"#5 on {name}: {exc}")
            else:
                check(False, f"#5 took {name}'s schedule")
            say("kernel", case=f"fs_{name}_refused", reason="single-active-step")
        out["classes"][name] = flat_class_times(card, name, p32, s32, fs_plain_s)
        out["classes"][name].update(build=pack_problem(p32).build, ls_max_abs_err=ls_err, fs_max_abs_err=fs_err)
    # SolverParams' μ and multiplier caps, both binding on the headline: #5
    # in f64 against the plain version in each program (the plan picks the
    # streamed one at B = 4096, the resident one at B = 1000); and the
    # streamed program in f32 at the headline, where the plan picks the
    # resident one
    for label, Bk in (("streamed", B), ("resident", 1000)):
        capped = flat_solve_vs_plain(f"fs_capped_f64_{label}_B{Bk}_T{T}", f64, Bk, params=HEADLINE_CAPS,
                                     program=label)[2]  # fmt: skip
        check(float(capped.mu.max()) == HEADLINE_CAPS.mu_max
              and float(capped.mults.jac.abs().max()) == HEADLINE_CAPS.mult_max,
              f"fs_capped_f64_{label}: the caps did not bind")  # fmt: skip
    flat_solve_vs_plain(f"fs_headline_f32_streamed_B{B}_T{T}", f32, B, program="streamed")
    # the fleet's own shapes (16b): #4 at T = 100, #5 at T = 100 and its f64
    # check's 8 iterations (μ ≤ 1e9), from 16b's float32 starts; the plain
    # float64 solve is 16b's yardstick of its float32 routes too
    spec = flat_class_spec("state", STATE_T)
    fleet_x0s = headline_x0s(f32)
    for dtype, bar, same in ((f64, 1e-10, 1.0), (f32, 2e-5, 0.99)):
        linesearch_vs_plain(f"ls_state_{'f64' if dtype == f64 else 'f32'}_B{B}_T{STATE_T}_C4",
                            *linesearch_inputs(B, dtype, Tk=STATE_T, spec=spec), 4, bar, same)  # fmt: skip
    fleet_kw = dict(spec=spec, params=STATE64, resolution=True)
    wide = flat_solve_vs_plain(f"fs_state_f64_B{B}_T{STATE_T}_I{STATE64.max_iterations}", f64, B,
                               x0s=fleet_x0s.double(), **fleet_kw)[2]  # fmt: skip
    flat_solve_vs_plain(f"fs_state_f32_B{B}_T{STATE_T}_I{STATE64.max_iterations}", f32, B, x0s=fleet_x0s,
                        wide=wide, **fleet_kw)  # fmt: skip
    for dims, Tk in (((2, 1, 2), STATE_T), ((2, 1, 3), T)):
        label = f"n{dims[0]}m{dims[1]}e{dims[2]}"
        kernel_vs_plain(f"gn_{label}_f64_B{B}_T{Tk}", *spd_inputs(B, Tk, *dims, f64), 1, 1e-10, 1e-10)
        inputs32 = spd_inputs(B, Tk, *dims, f32)
        err = kernel_vs_plain(f"gn_{label}_f32_B{B}_T{Tk}", *inputs32, 1, 2e-4, 2e-5)[0]
        ladder = time_ladder(card, label, inputs32, 1, (Tk, *dims, B))
        plan = rs.plan_launch(*inputs32[0], inputs32[1], torch.stack(_reg_levels(*inputs32[1:], 1)))
        ladder["device_ms"] = device_ms(lambda: rs.launch_plan(plan))
        out["riccati"][label] = dict(ladder, shape=f"{label}_T{Tk}_B{B}_L1_f32", max_abs_err=err)
    say("phase16a", wall_s=f"{time.perf_counter() - t0:.1f}")

    # 16b: the arrive-at-rest fleet on three routes
    t1 = time.perf_counter()
    spec = flat_class_spec("state", STATE_T)
    p32, x32 = problem_from_numpy(spec, device=DEV, dtype=f32), headline_x0s(f32)

    def expect(route, iters):
        # path A: #1 and #4 before the loop and once an iteration
        n = 1 + iters if route == "A" else 0
        return dict(riccati=n, fd=0, fd2=0, linesearch=n, flat_solve=int(route == "B"), levels_swept=n)

    res, fleet = {}, {}
    for route in ("sweep", "A", "B"):
        res[route], counts, wall = flat_route(p32, STATE, x32, route)
        check(counts == expect(route, STATE.max_iterations),
              f"fleet route {route}: launches {counts} != {expect(route, STATE.max_iterations)}")  # fmt: skip
        bad_lag = check_finite(res[route], f"fleet route {route}")
        check(res[route].us.shape == (B, STATE_T, 1) and res[route].xs.shape == (B, STATE_T + 1, 2),
              f"fleet route {route}: shapes")  # fmt: skip
        share = float((res[route].opt_constr < 1e-2).float().mean())
        check(share >= STATE_JAX_CPU_SHARE - 0.01,
              f"fleet route {route}: share {share} below ddp_tpu's {STATE_JAX_CPU_SHARE} - 0.01")  # fmt: skip
        fleet[route] = dict(launch_counts=counts, feasible=share, solve_s=wall, solves_per_s=B / wall,
                            p99_eq=float(torch.quantile(res[route].opt_constr, 0.99)),
                            opt_lag_not_finite=bad_lag)  # fmt: skip
    r64 = {route: flat_route(problem_from_numpy(spec, device=DEV, dtype=f64), STATE64,
                             headline_x0s(f64)[:STATE_B64], route)[0] for route in ("sweep", "A", "B")}  # fmt: skip
    for route in ("A", "B"):
        agree, worst = lane_agreement(res[route], res["sweep"])
        bar = STATE_JAX_CPU_AGREE - 0.02
        check(agree >= bar, f"fleet route {route}: {agree} of lanes agree with the sweep route, bar {bar}")
        err64 = lane_scaled_err(r64[route], r64["sweep"])
        check(err64 <= 1e-8, f"fleet route {route}: f64 us max scaled err {err64}")
        check(torch.equal(r64[route].mu, r64["sweep"].mu), f"fleet route {route}: f64 per-lane mu differs")
        fleet[route].update(lanes_us_agree_sweep=agree, us_max_scaled_err=worst, f64_us_max_scaled_err=err64,
                            mu_equal_sweep=float((res[route].mu == res["sweep"].mu).float().mean()))  # fmt: skip
    # float32 at the f64 check's depth (8 iterations, μ ≤ 1e9): each route
    # against 16a's plain float64 solve from these starts; paths A and B as
    # close to it as the sweep route (lanes within 1e-3 of their scale less
    # 0.02, the worst lane within FD_F32_VS_PLAIN times the sweep's)
    wide_us = wide._replace(us=wide.us.float())
    near = {}
    for route in ("sweep", "A", "B"):
        r8, counts, _ = flat_route(p32, STATE64, x32, route)
        check(counts == expect(route, STATE64.max_iterations),
              f"fleet route {route} at 8 iterations: launches {counts}")  # fmt: skip
        near[route] = lane_agreement(r8, wide_us)
        fleet[route].update(f32_i8_lanes_agree_f64=near[route][0], f32_i8_worst_f64=near[route][1])
    for route in ("A", "B"):
        (agree8, worst8), (sweep_agree, sweep_worst) = near[route], near["sweep"]
        check(agree8 >= sweep_agree - 0.02 and worst8 <= FD_F32_VS_PLAIN * sweep_worst,
              f"fleet route {route} at 8 iterations: against f64 {agree8} of lanes (worst {worst8:.3e}), "
              f"the sweep route {sweep_agree} ({sweep_worst:.3e})")  # fmt: skip
    # #5 on a launch plan of the fleet, timed beside its bound
    fplan = fs.plan_launch(p32, STATE, x32, n_linesearch=4)
    fleet["B"].update(ms=event_ms(lambda: fs.launch_plan(fplan), reps=3),
                      device_ms=device_ms(lambda: fs.launch_plan(fplan), n=5), plan=dict(fplan.geometry))  # fmt: skip
    fleet["B"]["bound_ms"], fleet["B"]["bound_by"] = flat_solve_bound_ms(
        STATE_T, 2, 1, p32.ne, B, STATE.max_iterations, 4, flat_ops(p32))  # fmt: skip
    for route, f in fleet.items():
        say("fleet_route", card=f"'{card}'", route=route, B=B, T=STATE_T, iters=STATE.max_iterations,
            launches=f["launch_counts"], feasible=f["feasible"], feasible_ddp_tpu_cpu=STATE_JAX_CPU_SHARE,
            p99_eq=f"{f['p99_eq']:.3e}", opt_lag_not_finite=f["opt_lag_not_finite"],
            solve_s=f"{f['solve_s']:.4f}", solves_per_s=f"{f['solves_per_s']:.1f}",
            **{k: (f"{v:.3e}" if "err" in k else v) for k, v in f.items()
               if k in ("lanes_us_agree_sweep", "us_max_scaled_err", "f64_us_max_scaled_err", "mu_equal_sweep",
                        "f32_i8_lanes_agree_f64", "f32_i8_worst_f64", "ms", "device_ms", "bound_ms", "bound_by",
                        "plan")})  # fmt: skip
    say("fleet", agree_bar=STATE_JAX_CPU_AGREE - 0.02, ddp_tpu_cpu_agree_sweep_assoc=STATE_JAX_CPU_AGREE,
        f64_B=STATE_B64, f64_iters=STATE64.max_iterations, f64_mu_identical=True,
        mu_max_f32=float(res["sweep"].mu.max()), mu_max_f64=float(r64["sweep"].mu.max()),
        wall_s=f"{time.perf_counter() - t1:.1f}")  # fmt: skip
    out["fleet"] = fleet

    # 16c: the RK4 tracking twin through path B
    t2 = time.perf_counter()
    spec = flat_class_spec("rk4_tracking", TRACK_T)
    p32 = problem_from_numpy(spec, device=DEV, dtype=f32)
    rb, cb, wall_b = flat_route(p32, TRACK, x32, "B")
    rsw, csw, wall_s = flat_route(p32, TRACK, x32, "sweep")
    check(cb == expect("B", TRACK.max_iterations) and csw == expect("sweep", TRACK.max_iterations),
          f"tracking twin launches {cb}, {csw}")  # fmt: skip
    for r, label in ((rb, "B"), (rsw, "sweep")):
        check_finite(r, f"tracking twin {label}")
    agree, worst = lane_agreement(rb, rsw)
    check(agree >= 0.99, f"tracking twin: only {agree} of lanes agree with the sweep route")
    p64 = problem_from_numpy(spec, device=DEV, dtype=f64)
    x64 = headline_x0s(f64)[:TRACK_B64]
    b64, s64 = (flat_route(p64, TRACK, x64, route)[0] for route in ("B", "sweep"))
    err64, bar64 = lane_scaled_err(b64, s64), 1e-8
    if err64 > bar64:
        # near convergence the line search's Δcost ≤ 0 is a roundoff draw: on
        # the CPU a 1e-15 relative change of x0 moves the sweep route's f64
        # controls by 2.0e-8 of each lane's scale, so hold path B to 10× that
        bar64 = resolution_bars(bar64, lambda x: flat_route(p64, TRACK, x, "sweep")[0], x64,
                                lambda r: {"us": lane_scaled_err(r, s64)})[0]["us"]  # fmt: skip
    check(err64 <= bar64, f"tracking twin: f64 us max scaled err {err64}, bar {bar64:.1e}")
    check(torch.equal(b64.mu, s64.mu), "tracking twin: f64 per-lane mu differs")
    moved = float((rb.xs[:, -1, 0] - x32[:, 0]).abs().mean())
    tplan = fs.plan_launch(p32, TRACK, x32, n_linesearch=4)
    out["tracking"] = dict(launch_counts=cb, lanes_us_agree_sweep=agree, us_max_scaled_err=worst,
                           f64_us_max_scaled_err=err64, f64_bar=bar64, solve_s=wall_b, solves_per_s=B / wall_b,
                           sweep_solve_s=wall_s, ms=event_ms(lambda: fs.launch_plan(tplan), reps=5),
                           device_ms=device_ms(lambda: fs.launch_plan(tplan), n=20), plan=dict(tplan.geometry))  # fmt: skip
    out["tracking"]["bound_ms"], out["tracking"]["bound_by"] = flat_solve_bound_ms(
        TRACK_T, 2, 1, p32.ne, B, TRACK.max_iterations, 4, flat_ops(p32))  # fmt: skip
    say("tracking_twin", card=f"'{card}'", B=B, T=TRACK_T, iters=TRACK.max_iterations, launches=cb,
        lanes_us_agree_sweep=agree, us_max_scaled_err=f"{worst:.3e}", mean_q_moved=f"{moved:.3f}",
        f64_B=TRACK_B64, f64_us_max_scaled_err=f"{err64:.3e}", f64_bar=f"{bar64:.1e}", f64_mu_identical=True,
        solve_s_B=f"{wall_b:.4f}", solve_s_sweep=f"{wall_s:.4f}", solves_per_s_B=f"{B / wall_b:.1f}",
        solves_per_s_sweep=f"{B / wall_s:.1f}", kernel_ms=f"{out['tracking']['ms']:.4f}",
        kernel_device_ms=f"{out['tracking']['device_ms']:.4f}", bound_ms=f"{out['tracking']['bound_ms']:.5f}",
        plan=out["tracking"]["plan"], wall_s=f"{time.perf_counter() - t2:.1f}")  # fmt: skip
    out["wall_s"] = time.perf_counter() - t0
    say("phase16", wall_s=f"{out['wall_s']:.1f}")
    return out


def build_kernels():
    """Phase 2: every library the run loads (#1 at ``RICCATI_SHAPES``, #2 and
    #3 at ``FD_JOINTS``, #4 and #5 at the classes of ``flat_class_spec``
    they run), one nvcc each, as many at once as the host has cores.  Returns the libraries built and nvcc's
    seconds for each."""
    t0 = time.perf_counter()
    jobs = [(f"riccati_small_n{n}m{m}e{e}{'_so' if so else ''}", rs, (n, m, e, so),
             rs.instantiation(n, m, e, so)) for n, m, e, so in RICCATI_SHAPES]  # fmt: skip
    jobs += [(f"{mod.SOURCE[:-3]}_nv{nv}", mod, (nv,), fd.instantiation(nv))
             for mod in (fd, fd2) for nv in FD_JOINTS]  # fmt: skip
    jobs += [(f"{mod.SOURCE[:-3]}_dyn{c['DYN']}_cost{c['COST']}_e{c['E']}", mod, (c,), c)
             for mod, names in ((lsf, ("headline", "e0") + FLAT_CLASSES),
                                (fs, ("headline", "e0") + FS_CLASSES))
             for c in flat_builds(names)]  # fmt: skip
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        for built in [pool.submit(mod._kernel_fn, *args) for _, mod, args, _ in jobs]:
            built.result()
    nvcc_s = {name: _build.build_seconds(mod.SOURCE, c) for name, mod, _, c in jobs}
    say("build", libraries=len(jobs), wall_s=f"{time.perf_counter() - t0:.1f}",
        nvcc_s={k: f"{v:.1f}" for k, v in nvcc_s.items()})  # fmt: skip
    return _build.loaded(), nvcc_s


def riccati_checks():
    """Kernel #1, the whole reg ladder in one launch, against its plain
    version at every instantiation in both types: the headline's one level
    at (2, 1, 1) (B=4096, ragged B=1000, a lane no level saves), the arm's
    and UR5's four at (14, 7, 3) and (12, 6, 6), the second-order ones; and
    the ladder itself: a lane that fails at reg and at the first escalation
    takes the second, bit for bit what a launch at that level alone gives,
    and a lane no level saves keeps level 0.  Returns the f32 inputs and
    errors at the main paths' shapes and the f64 inputs the timing reuses."""
    out = {}
    f32_in = pendulum_inputs(B, torch.float32)
    out["err32"] = kernel_vs_plain("headline_f32_B4096_T32", *f32_in, 1, 2e-4, 2e-5)[0]
    kernel_vs_plain("headline_f64_B4096_T32", *pendulum_inputs(B, torch.float64), 1, 1e-10, 1e-10)
    kernel_vs_plain("ragged_f64_B1000_T32", *pendulum_inputs(1000, torch.float64), 1, 1e-10, 1e-10)
    _, ok, _ = kernel_vs_plain("nonpd_lane3_f64_B1000",
                               *pendulum_inputs(1000, torch.float64, 3), 1, 1e-10, 1e-10)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail")
    ur5_64 = spd_inputs(UR5_B, UR5_H, 12, 6, 6, torch.float64)
    kernel_vs_plain("ur5dims_f64_B512_T16", *ur5_64, UR5_REG_LEVELS, 1e-9, 1e-9)
    ur5_in = spd_inputs(UR5_B, UR5_H, 12, 6, 6, torch.float32)
    out["ur5_err32"] = kernel_vs_plain("ur5dims_f32_B512_T16", *ur5_in, UR5_REG_LEVELS, 2e-3, 2e-4)[0]
    out["ur5_in"] = ur5_in
    arm_64 = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float64)
    kernel_vs_plain("armdims_f64_B256_T16", *arm_64, ARM_REG_LEVELS, 1e-9, 1e-9)
    arm_in = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float32)
    out["arm_err32"] = kernel_vs_plain("armdims_f32_B256_T16", *arm_in, ARM_REG_LEVELS, 2e-3, 2e-4)[0]
    kernel_vs_plain("armdims_ragged_f32_B1000_T16", *spd_inputs(1000, ARM_H, 14, 7, 3, torch.float32),
                    ARM_REG_LEVELS, 2e-3, 2e-4)  # fmt: skip
    # the quadrotor row's (12, 6, 12) at its shape and ladder depth
    quad_64 = spd_inputs(QUAD_B, QUAD_H, 12, 6, 12, torch.float64)
    kernel_vs_plain("quaddims_f64_B256_T32", *quad_64, QUAD_REG_LEVELS, 1e-9, 1e-9)
    quad_in = spd_inputs(QUAD_B, QUAD_H, 12, 6, 12, torch.float32)
    out["quad_err32"] = kernel_vs_plain("quaddims_f32_B256_T32", *quad_in, QUAD_REG_LEVELS,
                                        2e-3, 2e-4)[0]  # fmt: skip
    _, ok, _ = kernel_vs_plain("quaddims_nonpd_lane3_f64_B256_T32",
                               *spd_inputs(QUAD_B, QUAD_H, 12, 6, 12, torch.float64, bad_lane=3),
                               1, 1e-9, 1e-9)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail (12, 6, 12)")
    # … with the second-order terms, non-zero rank-3 slabs
    kernel_vs_plain("so_headline_f32_B4096_T32",
                    *spd_inputs(B, T, 2, 1, 1, torch.float32, second_order=True),
                    1, 2e-4, 2e-5, True)  # fmt: skip
    kernel_vs_plain("so_headline_f64_B4096_T32",
                    *spd_inputs(B, T, 2, 1, 1, torch.float64, second_order=True),
                    1, 1e-10, 1e-10, True)  # fmt: skip
    kernel_vs_plain("so_n4m2e2_ragged_f64_B1000_T16",
                    *spd_inputs(1000, 16, 4, 2, 2, torch.float64, second_order=True),
                    ARM_REG_LEVELS, 1e-9, 1e-9, True)  # fmt: skip
    kernel_vs_plain("so_n4m2e2_ragged_f32_B1000_T16",
                    *spd_inputs(1000, 16, 4, 2, 2, torch.float32, second_order=True),
                    ARM_REG_LEVELS, 2e-3, 2e-4, True)  # fmt: skip
    _, ok, _ = kernel_vs_plain("so_nonpd_lane3_f64_B1000",
                               *spd_inputs(1000, 16, 4, 2, 2, torch.float64, True, bad_lane=3),
                               1, 1e-9, 1e-9, True)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail (2nd order)")
    # UR5 under its 6-row ConfigTarget with the second-order terms (the UR5
    # chain's full-DDP stage), at its shape and ladder depth
    ur5so_64 = spd_inputs(UR5_B, UR5_H, 12, 6, 6, torch.float64, second_order=True)
    kernel_vs_plain("so_ur5dims_f64_B512_T16", *ur5so_64, UR5_REG_LEVELS, 1e-9, 1e-9, True)
    ur5so_in = spd_inputs(UR5_B, UR5_H, 12, 6, 6, torch.float32, second_order=True)
    out["ur5so_err32"] = kernel_vs_plain("so_ur5dims_f32_B512_T16", *ur5so_in, UR5_REG_LEVELS,
                                         2e-3, 2e-4, True)[0]  # fmt: skip
    _, ok, _ = kernel_vs_plain("so_ur5dims_nonpd_lane3_f64_B512_T16",
                               *spd_inputs(UR5_B, UR5_H, 12, 6, 6, torch.float64, True, bad_lane=3),
                               1, 1e-9, 1e-9, True)  # fmt: skip
    check(not bool(ok[3]) and int(ok.sum()) == ok.numel() - 1, "only lane 3 may fail (12, 6, 6) 2nd order")
    # the pendulum under a 2-row StateTarget, full DDP (the MPC loop of phase 10)
    kernel_vs_plain("so_pendulum_state_f64_B1000_T30",
                    *spd_inputs(1000, PEND_MPC_H, 2, 1, 2, torch.float64, second_order=True),
                    UR5_REG_LEVELS, 1e-10, 1e-10, True)  # fmt: skip
    kernel_vs_plain("so_pendulum_state_f32_B1000_T30",
                    *spd_inputs(1000, PEND_MPC_H, 2, 1, 2, torch.float32, second_order=True),
                    UR5_REG_LEVELS, 2e-4, 2e-5, True)  # fmt: skip
    arm2_64 = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float64, second_order=True)
    kernel_vs_plain("so_armdims_f64_B256_T16", *arm2_64, ARM_REG_LEVELS, 1e-9, 1e-9, True)
    arm2_in = spd_inputs(ARM_B, ARM_H, 14, 7, 3, torch.float32, second_order=True)
    out["rs2_err32"] = kernel_vs_plain("so_armdims_f32_B256_T16", *arm2_in, ARM_REG_LEVELS,
                                       2e-3, 2e-4, True)[0]  # fmt: skip
    # the ladder: lane 1 takes level 2, lane 2 no level, the others level 0
    for name, dims, dtype, so, bars in (
        ("ladder_armdims_f64_B256_T16", (14, 7, 3), torch.float64, False, (1e-9, 1e-9)),
        ("ladder_quaddims_f32_B256_T16", (12, 6, 12), torch.float32, False, (2e-3, 2e-4)),
        ("ladder_so_armdims_f64_B256_T16", (14, 7, 3), torch.float64, True, (1e-9, 1e-9)),
        ("ladder_so_armdims_f32_B256_T16", (14, 7, 3), torch.float32, True, (2e-3, 2e-4)),
        ("ladder_so_n4m2e2_f64_B1000_T16", (4, 2, 2), torch.float64, True, (1e-9, 1e-9)),
        ("ladder_so_ur5dims_f64_B256_T16", (12, 6, 6), torch.float64, True, (1e-9, 1e-9)),
        ("ladder_so_ur5dims_f32_B256_T16", (12, 6, 6), torch.float32, True, (2e-3, 2e-4)),
    ):  # fmt: skip
        Bk = 1000 if dims[0] == 4 else ARM_B
        inputs, mu, reg = spd_inputs(Bk, ARM_H, *dims, dtype, so, ladder=True)
        _, ok, got = kernel_vs_plain(name, inputs, mu, reg, ARM_REG_LEVELS, *bars, so)
        levels = torch.stack(_reg_levels(mu, reg, ARM_REG_LEVELS))
        check(ok.tolist()[:3] == [True, True, False] and bool(ok[3:].all()), f"{name}: ok {ok[:4]}")
        check(float(got[3][1]) == float(levels[2, 1]) and float(got[3][2]) == float(levels[0, 2]),
              f"{name}: reg_used {got[3][:3].tolist()}")  # fmt: skip
        check(bool(torch.isnan(got[0][2]).all()), f"{name}: the unsaved lane's gains are not level 0's NaN")
        alone = rs.backward_ladder(*inputs, mu, levels[2:3].contiguous(), so)
        check(torch.equal(got[0][1], alone[0][1]) and torch.equal(got[1][1], alone[1][1]),
              f"{name}: lane 1's gains are not bit for bit those of its level alone")  # fmt: skip
        say("kernel", case=name, lane1_level=2, lane1_bitwise_vs_level_alone=True,
            lane2_saved=False)  # fmt: skip
    out.update(f32_in=f32_in, arm_in=arm_in, arm2_in=arm2_in, arm_64=arm_64, arm2_64=arm2_64,
               ur5_64=ur5_64, quad_in=quad_in, quad_64=quad_64, ur5so_in=ur5so_in,
               ur5so_64=ur5so_64)  # fmt: skip
    return out


def kernel_checks():
    """Phase 3: every kernel against its plain version on the card.  Returns
    what the timing phase reuses: the f32 inputs at the main paths' shapes
    and each kernel's largest f32 error."""
    rc = riccati_checks()
    panda32 = robots.panda7(device=DEV, dtype=torch.float32)
    panda64 = robots.panda7(device=DEV, dtype=torch.float64)
    N = ARM_B * ARM_H
    fd_err32, fd_in = fd_kernel_vs_plain(f"panda7_f32_N{N}", panda32, N, torch.float32, panda64)
    fd_kernel_vs_plain(f"panda7_f64_N{N}", panda64, N, torch.float64)
    fd_kernel_vs_plain(f"cartpole_f64_N{N}", robots.cartpole(device=DEV, dtype=torch.float64),
                       N, torch.float64)  # fmt: skip
    fd_kernel_vs_plain("panda7_ragged_f64_N1000", panda64, 1000, torch.float64)
    fd2_err32, _ = fd_kernel_vs_plain(f"fd2_panda7_f32_N{N}", panda32, N, torch.float32,
                                      panda64, second=True)  # fmt: skip
    fd_kernel_vs_plain(f"fd2_panda7_f64_N{N}", panda64, N, torch.float64, second=True)
    fd_kernel_vs_plain(f"fd2_cartpole_f64_N{N}", robots.cartpole(device=DEV, dtype=torch.float64),
                       N, torch.float64, second=True)  # fmt: skip
    fd_kernel_vs_plain("fd2_panda7_ragged_f64_N1000", panda64, 1000, torch.float64, second=True)
    # UR5 (nv = 6) at the UR5 chain's B·H samples
    ur5_32 = robots.ur5(device=DEV, dtype=torch.float32)
    ur5_64 = robots.ur5(device=DEV, dtype=torch.float64)
    NU = UR5_B * UR5_H
    ur5_fd_err32, ur5_fd_in = fd_kernel_vs_plain(f"ur5_f32_N{NU}", ur5_32, NU, torch.float32, ur5_64)
    fd_kernel_vs_plain(f"ur5_f64_N{NU}", ur5_64, NU, torch.float64)
    fd_kernel_vs_plain("ur5_ragged_f64_N1000", ur5_64, 1000, torch.float64)
    fd_kernel_vs_plain("ur5_ragged_f32_N1000", ur5_32, 1000, torch.float32, ur5_64)
    ur5_fd2_err32, _ = fd_kernel_vs_plain(f"fd2_ur5_f32_N{NU}", ur5_32, NU, torch.float32, ur5_64,
                                          second=True)  # fmt: skip
    fd_kernel_vs_plain(f"fd2_ur5_f64_N{NU}", ur5_64, NU, torch.float64, second=True)
    fd_kernel_vs_plain("fd2_ur5_ragged_f64_N1000", ur5_64, 1000, torch.float64, second=True)
    fd_kernel_vs_plain("fd2_ur5_ragged_f32_N1000", ur5_32, 1000, torch.float32, ur5_64, second=True)

    # … the fused line search and the whole solve of the flat-lane class
    ls_problem, ls_state, ls_err32 = linesearch_checks()
    fs_err32, fs_plain_s = flat_solve_checks()

    return dict(rc, panda32=panda32, panda64=panda64, fd_in=fd_in, fd_err32=fd_err32,
                fd2_err32=fd2_err32, ur5_model32=ur5_32, ur5_model64=ur5_64, ur5_fd_in=ur5_fd_in,
                ur5_fd_err32=ur5_fd_err32, ur5_fd2_err32=ur5_fd2_err32,
                ls_problem=ls_problem, ls_state=ls_state,
                ls_err32=ls_err32, fs_err32=fs_err32, fs_plain_s=fs_plain_s)  # fmt: skip


def main():
    t_start = time.perf_counter()
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
    built, nvcc_s = build_kernels()

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
    (arm_rs_launches, arm_rs_levels), arm_fd_launches, a32, ax32, au32, gn_k, gn_j, gn64, arm_time = arm_main_path()
    arm_walls, arm_peak_mb = arm_time

    # 6. arm, full second-order DDP
    fd2_launches, (rs2_launches, rs2_levels), a2_32, chain = arm_second_order_path(
        ax32, au32, gn_k, gn_j, gn64
    )
    del gn64

    # 7. quadrotor row through the Riccati kernel at (12, 6, 12)
    (quad_launches, quad_levels), quad = quadrotor_path()

    # 8. the single-trajectory entry point on the card
    solve_walls = solve_path()

    # 9. the UR5 Gauss-Newton → full-DDP chain through #1, #2 and #3 at UR5's
    # dimensions
    ur5c = ur5_chain_path()

    # 10. the UR5 MPC replan, both routes, and the closed loops
    ur5m = ur5_mpc_path()

    # 11. times
    rt = {
        "headline": time_ladder(card, "n2m1e1", f32_in, 1, (T, 2, 1, 1, B)),
        "arm": time_ladder(card, "n14m7e3", arm_in, ARM_REG_LEVELS, (ARM_H, 14, 7, 3, ARM_B)),
        "arm_f64": time_ladder(card, "n14m7e3", k3["arm_64"], ARM_REG_LEVELS, (ARM_H, 14, 7, 3, ARM_B)),
        "ur5_f64": time_ladder(card, "n12m6e6", k3["ur5_64"], ARM_REG_LEVELS, (16, 12, 6, 6, 512)),
        "arm_so": time_ladder(card, "n14m7e3", arm2_in, ARM_REG_LEVELS, (ARM_H, 14, 7, 3, ARM_B), True),
        "arm_so_f64": time_ladder(card, "n14m7e3", k3["arm2_64"], ARM_REG_LEVELS,
                                  (ARM_H, 14, 7, 3, ARM_B), True),
        "quad": time_ladder(card, "n12m6e12", k3["quad_in"], QUAD_REG_LEVELS,
                            (QUAD_H, 12, 6, 12, QUAD_B)),
        "quad_f64": time_ladder(card, "n12m6e12", k3["quad_64"], QUAD_REG_LEVELS,
                                (QUAD_H, 12, 6, 12, QUAD_B)),
        "ur5": time_ladder(card, "n12m6e6", k3["ur5_in"], UR5_REG_LEVELS, (UR5_H, 12, 6, 6, UR5_B)),
        "ur5_so": time_ladder(card, "n12m6e6", k3["ur5so_in"], UR5_REG_LEVELS,
                              (UR5_H, 12, 6, 6, UR5_B), True),
        "ur5_so_f64": time_ladder(card, "n12m6e6", k3["ur5so_64"], UR5_REG_LEVELS,
                                  (UR5_H, 12, 6, 6, UR5_B), True),
        # one lane, as the MPC replans launch it
        "ur5_replan": time_ladder(card, "n12m6e6", spd_inputs(1, UR5_H, 12, 6, 6, torch.float32),
                                  UR5_REG_LEVELS, (UR5_H, 12, 6, 6, 1)),
        "pendulum_replan_so_f64": time_ladder(
            card, "n2m1e2", spd_inputs(1, PEND_MPC_H, 2, 1, 2, torch.float64, True),
            UR5_REG_LEVELS, (PEND_MPC_H, 2, 1, 2, 1), True),
    }  # fmt: skip
    for key, so, triplet in (("ur5", False, "ur5_in"), ("ur5_so", True, "ur5so_in")):
        inputs, mu, reg = k3[triplet]
        plan = rs.plan_launch(*inputs, mu, torch.stack(_reg_levels(mu, reg, UR5_REG_LEVELS)), so)
        rt[key]["device_ms"] = device_ms(lambda: rs.launch_plan(plan))
    say("time_backward_device", card=f"'{card}'", shape=f"n12m6e6_T{UR5_H}_B{UR5_B}_L{UR5_REG_LEVELS}",
        device_ms_f32=f"{rt['ur5']['device_ms']:.4f}",
        device_ms_2nd_order_f32=f"{rt['ur5_so']['device_ms']:.4f}")  # fmt: skip
    for key in ("quad", "quad_f64"):
        inputs, mu, reg = k3["quad_in" if key == "quad" else "quad_64"]
        plan = rs.plan_launch(*inputs, mu, torch.stack(_reg_levels(mu, reg, QUAD_REG_LEVELS)))
        rt[key]["device_ms"] = device_ms(lambda: rs.launch_plan(plan))
    say("time_backward_device", card=f"'{card}'", shape=f"n12m6e12_T{QUAD_H}_B{QUAD_B}_L{QUAD_REG_LEVELS}",
        device_ms_f32=f"{rt['quad']['device_ms']:.4f}", device_ms_f64=f"{rt['quad_f64']['device_ms']:.4f}")  # fmt: skip
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

    # the fused line search: the kernel on a checked launch plan, the
    # wrapper's whole call as path A makes it (the problem packed once), the
    # plain version
    ls_problem, ls_state = k3["ls_problem"], k3["ls_state"]
    n_ls = HEADLINE_KW["n_linesearch"]
    ls_flat = pack_problem(ls_problem)
    ls_plan = lsf.plan_launch(ls_problem, *ls_state, n_ls, flat=ls_flat)
    ls_ms = event_ms(lambda: lsf.launch_plan(ls_plan))
    ls_device_ms = device_ms(lambda: lsf.launch_plan(ls_plan))
    ls_call_ms = event_ms(lambda: lsf.linesearch(ls_problem, *ls_state, n_ls, flat=ls_flat))
    ls_plain_ms = event_ms(lambda: lsf.linesearch_reference(ls_problem, *ls_state, n_ls), reps=5)
    ls_bound, ls_bound_by = linesearch_bound_ms(T, 2, 1, 1, B, n_ls)
    ls_p64, ls_s64 = linesearch_inputs(B, torch.float64)
    ls_plan64 = lsf.plan_launch(ls_p64, *ls_s64, n_ls)
    ls_f64_ms = event_ms(lambda: lsf.launch_plan(ls_plan64))
    ls_device_f64_ms = device_ms(lambda: lsf.launch_plan(ls_plan64))
    say("time_linesearch", card=f"'{card}'", shape=f"n2m1e1_T{T}_B{B}_C{n_ls}_f32",
        kernel_ms=f"{ls_ms:.4f}", kernel_device_ms=f"{ls_device_ms:.4f}",
        wrapper_call_ms=f"{ls_call_ms:.4f}", plain_ms=f"{ls_plain_ms:.4f}",
        bound_ms=f"{ls_bound:.5f}", bound_by=ls_bound_by,
        kernel_over_bound=f"{ls_ms / ls_bound:.1f}",
        device_over_bound=f"{ls_device_ms / ls_bound:.1f}", kernel_f64_ms=f"{ls_f64_ms:.4f}",
        kernel_device_f64_ms=f"{ls_device_f64_ms:.4f}", chain_step_evaluations=T,
        plan_f32=ls_plan.geometry, plan_f64=ls_plan64.geometry)  # fmt: skip
    # the whole solve in one launch (the plain version was timed once, in
    # phase 3)
    fs_plan = fs.plan_launch(p32, HEADLINE, x32, n_linesearch=n_ls)
    fs_ms = event_ms(lambda: fs.launch_plan(fs_plan))
    fs_chain = flat_solve_chain_steps(T, HEADLINE.max_iterations, fs_plan.geometry["threads_per_lane"])
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
        chain_step_evaluations=fs_chain,
        us_per_chain_step=f"{1e3 * fs_ms / fs_chain:.4f}",
        plan_f32=fs_plan.geometry, plan_f64=fs_plan64.geometry)  # fmt: skip
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

    fd_ms = event_ms(lambda: fd.fd_derivs(panda32, *fd_in))
    fd_plain_ms = event_ms(lambda: fd.fd_derivs_reference(panda32, *fd_in), reps=5)
    fd_model_ms = event_ms(lambda: panda32.fd_derivatives(*fd_in), reps=5)
    fd_bound, fd_bound_by = fd_bound_ms(panda32, N)
    fd_f64_in = tuple(x.double() for x in fd_in)
    fd_f64_ms = event_ms(lambda: fd.fd_derivs(panda64, *fd_f64_in))
    fd_bound_f64, _ = fd_bound_ms(panda64, N, item=8)
    say("time_fd_derivs", card=f"'{card}'", shape=f"panda7_N{N}_f32", kernel_ms=f"{fd_ms:.4f}",
        plain_ms=f"{fd_plain_ms:.4f}", model_fd_derivatives_ms=f"{fd_model_ms:.4f}",
        bound_ms=f"{fd_bound:.5f}", bound_by=fd_bound_by,
        flops_per_sample=fd_flops(tuple(panda32.parents)),
        kernel_over_bound=f"{fd_ms / fd_bound:.1f}", kernel_f64_ms=f"{fd_f64_ms:.4f}",
        bound_f64_ms=f"{fd_bound_f64:.5f}")  # fmt: skip
    for deriv, backward in (("kernel", "kernel"), ("jvp", "sweep")):
        # phase 5's checked solves, the first of each route at this shape: a
        # timed solve of its own would cost the run ~8 s a route
        say("time_arm_solve", card=f"'{card}'", deriv=deriv, backward=backward, B=ARM_B,
            first_solve_s=f"{arm_walls[deriv]:.4f}", first_solve_solves_per_s=f"{ARM_B / arm_walls[deriv]:.1f}",
            peak_mem_mb=f"{arm_peak_mb[deriv]:.1f}")  # fmt: skip

    # kernels #2 and #3 at UR5's chain shape, and the chain on both routes
    ur5_32, ur5_64, ur5_fd_in = k3["ur5_model32"], k3["ur5_model64"], k3["ur5_fd_in"]
    NU = UR5_B * UR5_H
    ur5_fd_f64_in = tuple(x.double() for x in ur5_fd_in)
    ufd = dict(ms=event_ms(lambda: fd.fd_derivs(ur5_32, *ur5_fd_in)),
               plain_ms=event_ms(lambda: fd.fd_derivs_reference(ur5_32, *ur5_fd_in), reps=5),
               f64_ms=event_ms(lambda: fd.fd_derivs(ur5_64, *ur5_fd_f64_in)))  # fmt: skip
    ufd["bound_ms"], ufd["bound_by"] = fd_bound_ms(ur5_32, NU)
    ufd2 = dict(ms=event_ms(lambda: fd2.fd_derivs2(ur5_32, *ur5_fd_in)),
                plain_ms=event_ms(lambda: fd2.fd_derivs2_reference(ur5_32, *ur5_fd_in), reps=1, warm=False),
                f64_ms=event_ms(lambda: fd2.fd_derivs2(ur5_64, *ur5_fd_f64_in), reps=5))  # fmt: skip
    ufd2["bound_ms"], ufd2["bound_by"] = fd2_bound_ms(ur5_32, NU)
    for name, t in (("fd_derivs", ufd), ("fd_derivs2", ufd2)):
        say("time_" + name, card=f"'{card}'", shape=f"ur5_N{NU}_f32", kernel_ms=f"{t['ms']:.4f}",
            plain_ms=f"{t['plain_ms']:.4f}", bound_ms=f"{t['bound_ms']:.5f}", bound_by=t["bound_by"],
            kernel_over_bound=f"{t['ms'] / t['bound_ms']:.1f}", kernel_f64_ms=f"{t['f64_ms']:.4f}")  # fmt: skip
    # the chains of phase 9, one a route (a timed chain of its own would
    # cost the run ~9 s a route)
    for route, walls in (("kernel", ur5c["walls_kernel"]), ("jvp_sweep", ur5c["walls_jvp_sweep"])):
        ur5c["solves_per_s_" + route] = UR5_B / statistics.median(walls)
    say("time_ur5_chain", card=f"'{card}'", B=UR5_B,
        chain_s_kernel=[f"{w:.3f}" for w in ur5c["walls_kernel"]],
        chain_s_jvp_sweep=[f"{w:.3f}" for w in ur5c["walls_jvp_sweep"]],
        solves_per_s_kernel=f"{ur5c['solves_per_s_kernel']:.1f}",
        solves_per_s_jvp_sweep=f"{ur5c['solves_per_s_jvp_sweep']:.1f}", timed="phase_9_checked_chains",
        mpc_replan_p50_ms_kernel=f"{ur5m['kernel']['p50_ms']:.2f}",
        mpc_replan_p99_ms_kernel=f"{ur5m['kernel']['p99_ms']:.2f}",
        mpc_replan_p50_ms_sweep=f"{ur5m['sweep']['p50_ms']:.2f}",
        mpc_replan_p99_ms_sweep=f"{ur5m['sweep']['p99_ms']:.2f}")  # fmt: skip

    say("time_quadrotor_solve", card=f"'{card}'", B=QUAD_B,
        solve_s_kernel=f"{quad['wall_kernel']:.3f}", solve_s_sweep=f"{quad['wall_sweep']:.3f}",
        solves_per_s_kernel=f"{QUAD_B / quad['wall_kernel']:.2f}",
        solves_per_s_sweep=f"{QUAD_B / quad['wall_sweep']:.2f}",
        golden_solve_s=f"{solve_walls['golden_s']:.3f}",
        quadrotor_single_solve_s=f"{solve_walls['quadrotor_s']:.3f}")  # fmt: skip

    fd2_ms = event_ms(lambda: fd2.fd_derivs2(panda32, *fd_in))
    fd2_plain_ms = event_ms(lambda: fd2.fd_derivs2_reference(panda32, *fd_in), reps=2, warm=False)
    fd2_bound, fd2_bound_by = fd2_bound_ms(panda32, N)
    fd2_f64_in = tuple(x.double() for x in fd_in)
    fd2_f64_ms = event_ms(lambda: fd2.fd_derivs2(panda64, *fd2_f64_in), reps=5)
    fd2_plain_f64_ms = event_ms(lambda: fd2.fd_derivs2_reference(panda64, *fd2_f64_in), reps=1, warm=False)
    fd2_bound_f64, _ = fd2_bound_ms(panda64, N, item=8)
    say("time_fd_derivs2", card=f"'{card}'", shape=f"panda7_N{N}_f32", kernel_ms=f"{fd2_ms:.4f}",
        plain_ms=f"{fd2_plain_ms:.4f}", bound_ms=f"{fd2_bound:.5f}", bound_by=fd2_bound_by,
        flops_per_sample=fd2_flops(tuple(panda32.parents)),
        kernel_over_bound=f"{fd2_ms / fd2_bound:.1f}",
        kernel_f64_ms=f"{fd2_f64_ms:.4f}", plain_f64_ms=f"{fd2_plain_f64_ms:.4f}",
        bound_f64_ms=f"{fd2_bound_f64:.5f}")  # fmt: skip
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(1):  # phase 6 ran this stage: no warm-up
        t0 = time.perf_counter()
        ddp_stage(a2_32, ax32, gn_k, "kernel", "kernel")
        walls.append(time.perf_counter() - t0)
    ddp_wall = statistics.median(walls)
    say("time_arm_chain", card=f"'{card}'", deriv="kernel", backward="kernel", B=ARM_B,
        ddp_stage_s=[f"{w:.4f}" for w in walls],
        ddp_stage_solves_per_s=f"{ARM_B / ddp_wall:.1f}",
        chain_solves_per_s_first_gn=f"{ARM_B / (arm_walls['kernel'] + ddp_wall):.1f}",
        ddp_stage_s_jvp_sweep=f"{chain['wall_jvp_sweep']:.4f}",
        chain_solves_per_s_jvp_sweep_first_gn=f"{ARM_B / (arm_walls['jvp'] + chain['wall_jvp_sweep']):.1f}",
        peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")  # fmt: skip

    # 12. the associative-scan backward and the precision envelope
    p12 = assoc_and_envelope(card)

    # 13. the sharded paths: the mesh, solve_vmap, fleet MPC, entry.py
    p13 = sharded_paths(card)

    # 14. give_up_after's dead lanes, and the examples as entry points
    p14 = give_up_and_examples(card, (a32, ax32, au32))

    # 15. BASELINE configs[2], the double-pendulum reach, through #2 and #1 at
    # shapes built on demand
    p15 = double_pendulum_path(card)

    # 16. the flat-lane class of #4 and #5, the arrive-at-rest fleet through
    # paths A and B, the RK4 tracking twin through path B
    p16 = flat_classes_path(card)

    check(_build.loaded() == built, f"libraries built after phase 2: {_build.loaded() - built}")
    total_s = time.perf_counter() - t_start
    say("total", wall_s=f"{total_s:.1f}", phase16_s=f"{p16['wall_s']:.1f}")
    fleet = p16["fleet"]

    def class_rows(kernel):
        return {name: dict(c[kernel], build=c["build"], shape=f"{name}_T{T}_B{B}_C4_f32",
                           max_abs_err=c["ls_max_abs_err" if kernel == "linesearch" else "fs_max_abs_err"])
                for name, c in p16["classes"].items() if kernel in c}  # fmt: skip
    print(json.dumps({"kernels": [
        {
            "name": "riccati_small_bwd", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/riccati_small.cu",
            "replaces": "ddp_tpu/kernels/riccati_small.py:379",
            "launches": launches, "max_abs_err": err32, "ms": rt["headline"]["ms"],
            "plain_ms": rt["headline"]["plain_ms"], "bound_ms": rt["headline"]["bound_ms"],
            "bound_by": rt["headline"]["bound_by"], "library_ms": None,
            "wrapper_call_ms": rt["headline"]["wrapper_call_ms"],
            "arm_path": dict(
                rt["arm"], shape=f"n14m7e3_T{ARM_H}_B{ARM_B}_L{ARM_REG_LEVELS}_f32",
                launches=arm_rs_launches, levels_swept=arm_rs_levels, max_abs_err=k3["arm_err32"],
                f64_ms=rt["arm_f64"]["ms"],
                ur5dims_f64_ms=rt["ur5_f64"]["ms"],
            ),
            "quadrotor_path": dict(
                rt["quad"], shape=f"n12m6e12_T{QUAD_H}_B{QUAD_B}_L{QUAD_REG_LEVELS}_f32",
                launches=quad_launches, levels_swept=quad_levels, max_abs_err=k3["quad_err32"],
                f64_ms=rt["quad_f64"]["ms"], device_f64_ms=rt["quad_f64"]["device_ms"],
                solves_per_s=QUAD_B / quad["wall_kernel"], **quad,
            ),
            "ur5_path": dict(
                rt["ur5"], shape=f"n12m6e6_T{UR5_H}_B{UR5_B}_L{UR5_REG_LEVELS}_f32",
                launches=ur5c["launches_gn"]["riccati"],
                levels_swept=ur5c["launches_gn"]["levels_swept"], max_abs_err=k3["ur5_err32"],
                chain_solves_per_s_kernel=ur5c["solves_per_s_kernel"],
                chain_solves_per_s_jvp_sweep=ur5c["solves_per_s_jvp_sweep"], chain_timed="phase 9's checked chains",
                frac_gn=ur5c["frac_gn"], frac_chain=ur5c["frac_chain"],
                mpc_replan_kernel=ur5m["kernel"], mpc_replan_sweep=ur5m["sweep"],
                replan_shape=dict(rt["ur5_replan"], shape=f"n12m6e6_T{UR5_H}_B1_L{UR5_REG_LEVELS}_f32",
                                  launches_per_replan=ur5m["kernel"]["launches_per_replan"]["riccati"]),
            ),
            # phase 12: no launch on the assoc route; the f64 instantiation
            # as the yardstick of one backward="tf" call
            "assoc_path": dict(launches=p12["a"]["riccati_launches"],
                               t200_launches=p12["b"]["assoc"]["riccati_launches"]),
            # bench.py's T200 row on the kernel route: its launches, the
            # kernel against its plain version on that row's finished inputs
            "t200_path": dict(
                shape=f"n2m1e1_T{T200}_B{B}_L1_f32", launches=p12["b"]["kernel"]["riccati_launches"],
                max_abs_err=p12["b"]["kernel_err32"], f64_max_abs_err=p12["b"]["kernel_err64"],
                f32_from_f64=p12["b"]["kernel_f32_from_f64"], plain_f32_from_f64=p12["b"]["plain_f32_from_f64"],
                ms=p12["b"]["backward"]["kernel"]["ms"], device_ms=p12["b"]["backward"]["kernel"]["device_ms"],
                sweep_ms=p12["b"]["backward"]["sweep"]["ms"], assoc_ms=p12["b"]["backward"]["assoc"]["ms"],
                bound_ms=p12["b"]["bound_ms"], bound_by=p12["b"]["bound_by"],
            ),
            # phase 13: the headline sharded over the mesh (world size 1,
            # NCCL) and BASELINE configs[4]'s fleet replan through #1
            "mesh_path": dict(
                shape=f"n2m1e1_T{T}_B{B}_L{HEADLINE_KW['n_reg_levels']}_f32", launches=p13["headline"]["launches"],
                solves_per_s=p13["headline"]["solves_per_s"],
                fleet=dict(p13["fleet"], shape=f"n2m1e1_T{T}_B{FLEET_B}_L4_f32"),
                two_rank_split=p13["split"], dryrun_feasible=p13["dryrun"]["frac_feasible_1e-2"],
            ),
            # phase 14: the racing arm fleet without and with give_up_after
            # (each 1 + 24 launches sweeping 4 levels), ddp_tpu's give-up
            # case (f64), the fleet example (1 + 6 a replan)
            "give_up_path": dict(
                shape=f"n14m7e3_T{ARM_H}_B{ARM_B}_L{ARM_REG_LEVELS}_f32", arm=p14["a"],
                pendulum_f64_launches=p14["b"], fleet_example=p14["c"]["fleet"],
            ),
            # phase 15: BASELINE configs[2] through #1 at (4, 2, 2), 4 levels
            "double_pendulum_path": dict(p15["riccati"], **p15["path"]),
            # phase 16: (2, 1, 2) Gauss-Newton on the arrive-at-rest fleet's
            # path A (timed at its T = 100), (2, 1, 3) the stack's shape
            "arrive_at_rest_path": dict(p16["riccati"]["n2m1e2"], launches=fleet["A"]["launch_counts"]["riccati"],
                                        levels_swept=fleet["A"]["launch_counts"]["levels_swept"]),
            "stack_shape": p16["riccati"]["n2m1e3"],
            "nvcc_s": {k: v for k, v in nvcc_s.items() if k.startswith("riccati")},
            "tf_yardstick": dict(
                shape=f"n2m1e1_T{T}_B{B}_L{HEADLINE_KW['n_reg_levels']}_f64", launches=p12["c"]["launches"],
                max_abs_err=p12["c"]["max_abs_err"], max_rel_err=p12["c"]["max_rel_err"],
                ms=p12["c"]["kernel_f64_ms"],
                device_ms=p12["c"]["kernel_f64_device_ms"], plain_ms=p12["c"]["kernel_f64_plain_ms"],
                bound_ms=p12["c"]["bound_ms"], bound_by=p12["c"]["bound_by"], library_ms=None,
                tf_route_ms=p12["c"]["tf_ms"],
            ),
        },
        {
            "name": "fd_derivs", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/fd_derivs.cu",
            "replaces": "ddp_tpu/kernels/fd_derivs.py:500",
            "launches": arm_fd_launches, "max_abs_err": fd_err32, "ms": fd_ms,
            "plain_ms": fd_plain_ms, "bound_ms": fd_bound, "bound_by": fd_bound_by,
            "library_ms": None, "f64_ms": fd_f64_ms,
            "ur5_path": dict(ufd, shape=f"ur5_N{NU}_f32", launches=ur5c["launches_gn"]["fd"],
                             max_abs_err=k3["ur5_fd_err32"]),
            # phase 14a: the racing arm fleet, 1 + 24 + 1 launches a solve
            "give_up_path": dict(shape=f"panda7_N{N}_f32", launches_each=p14["a"]["launches"]["fd"]),
            # phase 15: BASELINE configs[2], nv = 2 over B·H samples
            "double_pendulum_path": p15["fd"],
            "nvcc_s": {k: v for k, v in nvcc_s.items() if k.startswith("fd_derivs_")},
        },
        {
            "name": "fd_derivs2", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/fd_derivs2.cu",
            "replaces": "ddp_tpu/kernels/fd_derivs2.py:357",
            "launches": fd2_launches, "max_abs_err": fd2_err32, "ms": fd2_ms,
            "plain_ms": fd2_plain_ms, "bound_ms": fd2_bound, "bound_by": fd2_bound_by,
            "library_ms": None, "f64_ms": fd2_f64_ms,
            "ur5_path": dict(ufd2, shape=f"ur5_N{NU}_f32", launches=ur5c["launches_ddp"]["fd2"],
                             max_abs_err=k3["ur5_fd2_err32"]),
            "nvcc_s": {k: v for k, v in nvcc_s.items() if k.startswith("fd_derivs2")},
        },
        {
            "name": "riccati_small_bwd_second_order", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/riccati_small.cu",
            "replaces": "ddp_tpu/kernels/riccati_small.py:379",
            "launches": rs2_launches, "levels_swept": rs2_levels, "max_abs_err": rs2_err32,
            "ms": rt["arm_so"]["ms"],
            "plain_ms": rt["arm_so"]["plain_ms"], "bound_ms": rt["arm_so"]["bound_ms"],
            "bound_by": rt["arm_so"]["bound_by"], "library_ms": None,
            "wrapper_call_ms": rt["arm_so"]["wrapper_call_ms"],
            "f64_ms": rt["arm_so_f64"]["ms"],
            "ur5_path": dict(
                rt["ur5_so"], shape=f"n12m6e6_T{UR5_H}_B{UR5_B}_L{UR5_REG_LEVELS}_f32",
                launches=ur5c["launches_ddp"]["riccati_second_order"],
                levels_swept=ur5c["launches_ddp"]["levels_swept"], max_abs_err=k3["ur5so_err32"],
                f64_ms=rt["ur5_so_f64"]["ms"], chain_solves_per_s=ur5c["solves_per_s_kernel"],
            ),
            "pendulum_mpc_path": dict(
                rt["pendulum_replan_so_f64"], shape=f"n2m1e2_T{PEND_MPC_H}_B1_L{UR5_REG_LEVELS}_f64",
                **ur5m["pendulum"],
            ),
        },
        {
            "name": "linesearch_flat", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/linesearch_flat.cu",
            "replaces": "ddp_tpu/kernels/linesearch_flat.py:321",
            "launches": ls_launches, "max_abs_err": k3["ls_err32"], "ms": ls_ms,
            "plain_ms": ls_plain_ms, "bound_ms": ls_bound, "bound_by": ls_bound_by,
            "library_ms": None, "wrapper_call_ms": ls_call_ms, "f64_ms": ls_f64_ms,
            "device_ms": ls_device_ms, "device_f64_ms": ls_device_f64_ms,
            "riccati_launches_on_its_path": ls_rs_launches,
            # phase 16: each class against its plain version and timed; the
            # arrive-at-rest fleet's path A
            "classes": class_rows("linesearch"),
            "arrive_at_rest_path": dict(fleet["A"], shape=f"state_T{STATE_T}_B{B}_C4_f32",
                                        launches=fleet["A"]["launch_counts"]["linesearch"]),
            "nvcc_s": {k: v for k, v in nvcc_s.items() if k.startswith("linesearch_flat")},
        },
        {
            "name": "flat_solve", "route": "cuda",
            "source": "ddp_tpu_torch/csrc/flat_solve.cu",
            "replaces": "ddp_tpu/kernels/flat_solve.py:690",
            "launches": fs_launches, "max_abs_err": k3["fs_err32"], "ms": fs_ms,
            "plain_ms": fs_plain_ms, "bound_ms": fs_bound, "bound_by": fs_bound_by,
            "library_ms": None, "wrapper_call_ms": fs_call_ms, "f64_ms": fs_f64_ms,
            "plan": fs_plan.geometry, "plan_f64": fs_plan64.geometry,
            # phase 12b: bench.py's T200 row through path B
            "t200_path": dict(p12["b"]["B"], shape=f"headline_T{T200}_B{B}_C4_f32"),
            # phase 16: each class it takes, the arrive-at-rest fleet's path
            # B, the RK4 tracking twin (a non-zero terminal cost)
            "classes": class_rows("flat_solve"),
            "arrive_at_rest_path": dict(fleet["B"], shape=f"state_T{STATE_T}_B{B}_C4_f32",
                                        launches=fleet["B"]["launch_counts"]["flat_solve"]),
            "tracking_twin": dict(p16["tracking"], shape=f"rk4_tracking_T{TRACK_T}_B{B}_C4_f32",
                                  launches=p16["tracking"]["launch_counts"]["flat_solve"]),
            "nvcc_s": {k: v for k, v in nvcc_s.items() if k.startswith("flat_solve")},
        },
    ]}))  # fmt: skip
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))  # fmt: skip


if __name__ == "__main__":
    main()
