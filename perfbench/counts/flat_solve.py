"""The least time of one whole flat-lane solve on one H100, frozen with the
benchmark so that the roofline and MFU shares read the same work whatever
implements it.  A copy of the arithmetic ``chip_smoke.py`` used for the
bounds of kernel #5 (``flat_ops``, ``flat_solve_bound_ms``), taking the
problem from a configuration file instead of the program's packed class.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit): 67 TFLOP/s in float32 outside the tensor cores,
34 TFLOP/s in float64, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

# operations of one step of the pendulum: Euler (a = -(g/l)·sin q + u/m: 4;
# q' and v': 4) or RK4 (u/m once, four accelerations of 3, the stages'
# arguments 12 and increments 9, the weighted sums 14); of each cost kind's
# stage cost with its sum into the step's (control (c/2)·u²: 3, tracking 12,
# manifold tracking 13) and its terminal cost (0, 8, 10)
DYN_FLOPS = {"euler": 8, "rk4": 39}
STAGE_FLOPS = {"quad_control": 3, "quad_tracking": 12, "manifold_tracking": 13}
TERMINAL_FLOPS = {"quad_control": 0, "quad_tracking": 8, "manifold_tracking": 10}
# the headline's class (Euler, the control cost): the step that the
# derivative count of ~40 operations was scaled from
STEP_FLOPS = DYN_FLOPS["euler"] + STAGE_FLOPS["quad_control"]
NX, M = 2, 1  # the pendulum's state and control widths
E_ROWS = {"none": 0, "config": 1, "state": 2}


def step_flops(cfg: dict) -> int:
    """Operations of one step's dynamics and stage cost."""
    return DYN_FLOPS[cfg.get("discretization", "euler")] + STAGE_FLOPS[cfg["cost"]["kind"]]


def solve_counts(cfg: dict, lanes: int) -> dict:
    """Operations and bytes of one float32 whole solve of ``lanes`` lanes of
    the configuration's problem, and its least time on the card: x0, us0 and
    the schedule state read once and the result (us, xs, fb_k, fb_K, six
    stats, multipliers) written once at the card's memory rate, or the
    operations of the function at the float32 peak: per pass and step the
    derivatives (3 Jacobian columns of the step, the cost's gradient and
    Hessian: ~40 for the headline's class, scaled by the class's step
    operations), the Riccati step, n_linesearch + 1 closed-loop cost
    evaluations, and per iteration the two adjoints (~2·nx·(nx + m)
    multiply-adds each); the constraint's value and Jacobian once a pass are
    left out.  Returns ops, bytes, bound_ms and bound_by ("operations" or
    "bytes")."""
    T, iters, n_ls = int(cfg["horizon"]), int(cfg["max_iterations"]), int(cfg["n_linesearch"])
    e = E_ROWS[cfg["constraint"]["kind"]]
    nx, m = NX, M
    sf = step_flops(cfg)
    derivs = 40 * sf / STEP_FLOPS
    item = 4
    per_lane = nx + T * m + 4
    per_lane += T * m + (T + 1) * nx + T * m + T * m * nx + 6 + T * e * (1 + nx)
    nbytes = per_lane * lanes * item
    macs = nx * nx * (nx + m) + (nx + m) * nx * (nx + m) + 2 * e * (nx + m) * nx
    macs += m**3 // 3 + (1 + nx) * m * m + m * nx * (1 + nx)
    rollout_step = nx + 2 * m * (1 + nx) + sf
    per_pass = T * (derivs + 2 * macs + (n_ls + 1) * rollout_step)
    per_iter = T * (derivs + 2 * 2 * 2 * nx * (nx + m))
    ops = lanes * (T * sf + (iters + 1) * per_pass + (iters + 1) * per_iter)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / F32_FLOPS_PER_S
    return dict(
        ops=ops, bytes=nbytes, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", peak_flops=F32_FLOPS_PER_S,
    )  # fmt: skip
