#!/usr/bin/env python3
"""UR5 reaching an end-effector target, on ddp_tpu_torch (≙
examples/ur5_reach.py, the analog of test/pinocchio_spatial_eq_ddp.cpp).

The bundled UR5 URDF, H = 12, dt 0.01, a ``FrameTarget`` on the end
effector at the position of q0 ⊕ (0.2, -0.15, 0.1, 0.05, -0.1, 0.08) enforced
two steps past H, ½‖u‖², Gauss-Newton, ``SolverParams(55, 1e-8, mu=1e8)``,
one trajectory through ``ddp_tpu_torch.solve``:

    python3 examples/torch_ur5_reach.py [--device cuda|cpu] [--dtype float64|float32]

On the card unless ``--device cpu``, in float64 by default (the card has
float64 arithmetic; examples/ur5_reach.py runs this solve on the host).
Prints what examples/ur5_reach.py prints.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ddp_tpu_torch import SolverParams, solve  # noqa: E402
from ddp_tpu_torch.models import robots  # noqa: E402
from ddp_tpu_torch.models.base import state_pack  # noqa: E402
from ddp_tpu_torch.ocp import constraints, costs, dynamics  # noqa: E402
from ddp_tpu_torch.ocp.problem import Problem  # noqa: E402

H = 12
GOAL_OFFSET = (0.2, -0.15, 0.1, 0.05, -0.1, 0.08)


def build(device="cuda", dtype=torch.float64, horizon=H):
    """The recipe: (problem, params, x0), x0 the neutral configuration at
    rest.  Raises on ``device="cuda"`` without a card."""
    kw = dict(device=device, dtype=dtype)
    arm = robots.ur5(**kw)
    dyn = dynamics.euler(arm, 0.01)
    fid = robots.ee_frame_id(arm)
    q0 = arm.neutral_configuration()
    p_target = arm.frame_position(fid, arm.integrate(q0, torch.tensor(GOAL_OFFSET, **kw)))
    con = constraints.advance_time(
        constraints.FrameTarget(arm, p_target, frame_id=fid, active_ts=(horizon,)), dyn, times=2
    )
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, **kw), constraint=con,
                      horizon=horizon, second_order=False)  # fmt: skip
    params = SolverParams(max_iterations=55, threshold=1e-8, mu=1e8)
    return problem, params, state_pack(q0, torch.zeros(arm.nv, **kw))


def main(device="cuda", dtype=torch.float64):
    """Solve the recipe and print the target, the reached end-effector
    position, |eq| and the iterations; returns (SolveResult, target,
    reached), the positions on the host."""
    problem, params, x0 = build(device, dtype)
    res = solve(problem, params, x0)
    arm, target = problem.model, problem.constraint.inner.inner
    p_target = target.target.cpu()
    p_final = arm.frame_position(target.frame_id, res.xs[-1, : arm.nq]).cpu()
    print(f"target EE position : {p_target.numpy()}")
    print(f"reached EE position: {p_final.numpy()}")
    print(f"|eq| = {float(res.stats.opt_constr):.3e}; iterations = {int(res.stats.iterations)}")
    return res, p_target, p_final


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    a = ap.parse_args()
    main(a.device, getattr(torch, a.dtype))
