#!/usr/bin/env python3
"""Pendulum swing-up with a terminal equality constraint, on ddp_tpu_torch
(≙ examples/pendulum_swingup.py, the analog of the reference's
test/pendulum_ddp.cpp).

Horizon 200, dt 0.01, target q = 3.14 enforced through a double time-advance
constraint, ½‖u‖², full second-order DDP, primal-dual affine multipliers, one
trajectory through ``ddp_tpu_torch.solve``:

    python3 examples/torch_pendulum_swingup.py [--device cuda|cpu] [--dtype float32|float64]

On the card unless ``--device cpu``; float32 (μ = 1e4) by default, float64
with μ = 1e8.  Prints what examples/pendulum_swingup.py prints.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ddp_tpu_torch import Method, SolverParams, solve  # noqa: E402
from ddp_tpu_torch.models.pendulum import pendulum  # noqa: E402
from ddp_tpu_torch.ocp import constraints, costs, dynamics  # noqa: E402
from ddp_tpu_torch.ocp.problem import Problem  # noqa: E402

HORIZON, DT = 200, 0.01


def build(device="cuda", dtype=torch.float32, horizon=HORIZON):
    """The recipe: (problem, params, x0).  Raises on ``device="cuda"``
    without a card."""
    kw = dict(device=device, dtype=dtype)
    model = pendulum(mass=1.0, length=1.0, **kw)
    dyn = dynamics.euler(model, DT)
    con = constraints.advance_time(
        constraints.ConfigTarget(model, torch.tensor([3.14], **kw), active_ts=(horizon,)), dyn, times=2
    )
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, **kw), constraint=con, horizon=horizon)
    mu = 1e8 if dtype == torch.float64 else 1e4
    return problem, SolverParams(max_iterations=60, threshold=1e-8, mu=mu), torch.zeros(2, **kw)


def main(device="cuda", dtype=torch.float32):
    """Solve the recipe, print the result and the trajectory every 25 steps
    as the reference's test program does; returns the SolveResult."""
    problem, params, x0 = build(device, dtype)
    res = solve(problem, params, x0, method=Method.PRIMAL_DUAL_AFFINE)
    xs, us = res.xs.cpu(), res.us.cpu()
    print(f"converged={bool(res.stats.converged)} after {int(res.stats.iterations)} iters")
    print(f"final q = {float(xs[-1, 0]):.8f} (target 3.14)")
    print(f"|eq| = {float(res.stats.opt_constr):.3e}")
    for t in range(0, HORIZON + 1, 25):
        u = float(us[min(t, HORIZON - 1), 0])
        print(f"t={t:3d}  q={float(xs[t, 0]):+8.4f}  v={float(xs[t, 1]):+8.4f}  u={u:+9.4f}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    a = ap.parse_args()
    main(a.device, getattr(torch, a.dtype))
