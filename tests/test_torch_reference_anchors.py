"""The reference anchors of ported modules that no other port test mirrors,
run through ddp_tpu_torch on the CPU at each anchor's own sizes and bars:
the constrained arm, cart-pole and double-pendulum solves, the stacked
waypoint constraints, the bf16 and f32-quadrotor batched solves, the batched
solver against the single-trajectory one, the method ladder and the
matmul-precision knob.  The ones the JAX package marks ``slow`` are marked
so here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ocp import constraints as jcons
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdyn
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.models.pendulum import pendulum as jpendulum
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch import Method, SolverParams, solve
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.base import state_integrate, state_pack
from ddp_tpu_torch.models.pendulum import pendulum
from ddp_tpu_torch.models.rigid_body import double_pendulum
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver.batched import solve_batched

from torch_parity_helpers import spec_of

F64 = dict(device="cpu", dtype=torch.float64)
F32 = dict(device="cpu", dtype=torch.float32)


def reach_problem(model, con, H, dt, c=1.0):
    """Euler dynamics, c/2‖u‖², ``con(model, dyn)`` advanced twice, Gauss-Newton."""
    kw = dict(device="cpu", dtype=next(model.buffers()).dtype)
    dyn = dynamics.euler(model, dt)
    return Problem(
        dynamics=dyn, cost=costs.quad_control(c, **kw),
        constraint=constraints.advance_time(con, dyn, times=2), horizon=H, second_order=False,
    )  # fmt: skip


def pendulum_problem(H, dtype=torch.float64):
    """tests/test_batched_solver.py's and test_methods_schedules.py's
    make_problem: the pendulum to 3.14 two steps past H, dt = 0.01."""
    kw = dict(device="cpu", dtype=dtype)
    model = pendulum(1.0, 1.0, **kw)
    con = constraints.ConfigTarget(model=model, target=torch.tensor([3.14], **kw), active_ts=(H,))
    return Problem(
        dynamics=dynamics.euler(model, 0.01), cost=costs.quad_control(1.0, **kw),
        constraint=constraints.advance_time(con, dynamics.euler(model, 0.01), times=2), horizon=H,
    )  # fmt: skip


# ------------------------------------------------------------- slow anchors


@pytest.mark.slow
def test_panda7_spatial_eq_ddp():
    """≙ test_model_zoo.py::test_panda7_spatial_eq_ddp (H = 10, f64, mu 1e8,
    40 iterations): opt_constr < 1e-5, the frame within 1e-4 of its target."""
    arm = robots.panda7(**F64)
    H = 10
    q0 = arm.neutral_configuration()
    p_target = arm.frame_position(0, arm.integrate(q0, 0.06 * torch.ones(7, dtype=torch.float64)))
    con = constraints.FrameTarget(model=arm, target=p_target, frame_id=0, active_ts=(H,))
    res = solve(reach_problem(arm, con, H, 0.01), SolverParams(40, 1e-8, mu=1e8),
                state_pack(q0, torch.zeros(7, dtype=torch.float64)))  # fmt: skip
    assert float(res.stats.opt_constr) < 1e-5
    np.testing.assert_allclose(arm.frame_position(0, res.xs[-1, :7]).numpy(), p_target.numpy(), atol=1e-4)


@pytest.mark.slow
def test_ur5_spatial_eq_ddp():
    """≙ test_arm_ddp.py::test_ur5_spatial_eq_ddp (H = 12, f64, mu 1e8, 55
    iterations): opt_constr < 1e-5, the end effector within 1e-4."""
    arm = robots.ur5(**F64)
    H = 12
    fid = robots.ee_frame_id(arm)
    q0 = arm.neutral_configuration()
    q_goal = arm.integrate(q0, torch.tensor([0.2, -0.15, 0.1, 0.05, -0.1, 0.08], dtype=torch.float64))
    p_target = arm.frame_position(fid, q_goal)
    con = constraints.FrameTarget(model=arm, target=p_target, frame_id=fid, active_ts=(H,))
    res = solve(reach_problem(arm, con, H, 0.01), SolverParams(55, 1e-8, mu=1e8),
                state_pack(q0, torch.zeros(arm.nv, dtype=torch.float64)))  # fmt: skip
    assert float(res.stats.opt_constr) < 1e-5
    np.testing.assert_allclose(arm.frame_position(fid, res.xs[-1, : arm.nq]).numpy(), p_target.numpy(),
                               atol=1e-4)  # fmt: skip


@pytest.mark.slow
def test_cartpole_swingup():
    """≙ test_model_zoo.py::test_cartpole_swingup (H = 120, dt 0.02, 0.1/2‖u‖²,
    f64, mu 1e8, 60 iterations): opt_constr < 1e-5, pole up and cart home
    within 1e-4."""
    m = robots.cartpole(**F64)
    H = 120
    q_up = torch.tensor([0.0, torch.pi], dtype=torch.float64)
    con = constraints.ConfigTarget(model=m, target=q_up, active_ts=(H,))
    res = solve(reach_problem(m, con, H, 0.02, c=1e-1), SolverParams(60, 1e-7, mu=1e8),
                torch.zeros(4, dtype=torch.float64))  # fmt: skip
    assert float(res.stats.opt_constr) < 1e-5
    np.testing.assert_allclose(res.xs[-1, :2].numpy(), q_up.numpy(), atol=1e-4)


@pytest.mark.slow
def test_double_pendulum_swingup():
    """≙ test_arm_ddp.py::test_double_pendulum_swingup (H = 150, dt 0.02,
    0.1/2‖u‖², f64, mu 1e6, 60 iterations): opt_constr < 1e-5, both links up
    within 1e-4."""
    model = double_pendulum(**F64)
    H = 150
    q_up = torch.tensor([torch.pi, 0.0], dtype=torch.float64)
    con = constraints.ConfigTarget(model=model, target=q_up, active_ts=(H,))
    res = solve(reach_problem(model, con, H, 0.02, c=1e-1), SolverParams(60, 1e-7, mu=1e6),
                torch.zeros(4, dtype=torch.float64))  # fmt: skip
    assert float(res.stats.opt_constr) < 1e-5
    assert float(model.difference(q_up, res.xs[-1, :2]).abs().max()) < 1e-4, res.xs[-1, :2]


@pytest.mark.slow
def test_quadrotor_attitude_reach_f32_batched():
    """≙ test_model_zoo.py::test_quadrotor_attitude_reach_f32_batched: 8
    freeflyers (f32, H = 20, dt 0.02) to a translated and rotated
    configuration target on the quaternion manifold through solve_batched
    (14 iterations, inner_iters_max=1): finite, opt_constr < 1e-2 on every
    lane, terminal quaternions within 1e-5 of unit norm."""
    m = robots.quadrotor(**F32)
    H = 20
    q0 = m.neutral_configuration()
    q_target = m.integrate(q0, torch.tensor([0.10, 0.0, 0.05, 0.3, 0.0, 0.0]))
    con = constraints.ConfigTarget(model=m, target=q_target, active_ts=(H,))
    rng = np.random.default_rng(0)
    x0 = state_pack(q0, torch.zeros(m.nv))
    x0s = state_integrate(m, x0.expand(8, -1), torch.tensor(0.05 * rng.standard_normal((8, 2 * m.nv)),
                                                            dtype=torch.float32))  # fmt: skip
    res = solve_batched(reach_problem(m, con, H, 0.02),
                        SolverParams(14, 1e-5, mu=1e4, inner_iters_max=1), x0s)  # fmt: skip
    assert bool(torch.isfinite(res.us).all())
    assert bool((res.opt_constr < 1e-2).all()), res.opt_constr
    qn = torch.linalg.vector_norm(res.xs[:, -1, 3:7].double(), dim=1)
    np.testing.assert_allclose(qn.numpy(), 1.0, atol=1e-5)


# ----------------------------------------------------------- tier-1 anchors


def test_stacked_and_trajectory_constraints():
    """≙ test_pendulum_solve.py::test_stacked_and_trajectory_constraints (H =
    60, f64, waypoints q = 0.8 at t = 30 and 1.5 at t = 60 through a
    TrajectoryConfigTarget under StackConstraints, mu 1e8, 50 iterations):
    opt_constr < 1e-6 and both waypoints within 1e-5; and the controls within
    1e-9 of ddp_tpu's largest |u| (the iteration counts may part past f64's
    floor, ROADMAP)."""
    H = 60
    jmodel = jpendulum(1.0, 1.0, dtype=jnp.float64)
    jd = jdyn.euler(jmodel, 0.01)
    targets = jnp.zeros((H + 1, 1), jnp.float64).at[30].set(0.8).at[H].set(1.5)
    track = jcons.advance_time(jcons.TrajectoryConfigTarget(model=jmodel, targets=targets, active_ts=(30, H)),
                               jd, times=2)  # fmt: skip
    jp = JProblem(dynamics=jd, cost=jcosts.quad_control(1.0, dtype=jnp.float64),
                  constraint=jcons.StackConstraints(parts=(track,)), horizon=H)  # fmt: skip
    tp = problem_from_numpy(spec_of(jp), **F64)
    params = dict(max_iterations=50, threshold=1e-8, mu=1e8)
    res = solve(tp, SolverParams(**params), torch.zeros(2, dtype=torch.float64))
    assert float(res.stats.opt_constr) < 1e-6
    assert abs(float(res.xs[30, 0]) - 0.8) < 1e-5
    assert abs(float(res.xs[H, 0]) - 1.5) < 1e-5
    jr = jsolve(jp, JParams(**params), jnp.zeros(2, jnp.float64))
    us_j = np.asarray(jr.us)
    assert np.abs(res.us.numpy() - us_j).max() <= 1e-9 * np.abs(us_j).max()


def test_pendulum_bf16_batched_solve():
    """≙ test_model_zoo.py::test_pendulum_bf16_batched_solve: a bf16 batched
    solve (H = 40, mu 1e2, 10 iterations, inner_iters_max=1, 8 lanes from
    q = 0.05·i) stays finite and feasible to 0.1 on every lane."""
    problem = pendulum_problem(40, torch.bfloat16)
    x0s = torch.tensor([[0.05 * i, 0.0] for i in range(8)], dtype=torch.bfloat16)
    res = solve_batched(problem, SolverParams(10, 1e-3, mu=1e2, inner_iters_max=1), x0s)
    assert bool(torch.isfinite(res.us.float()).all())
    assert bool((res.opt_constr.double() < 0.1).all()), res.opt_constr


def test_batched_matches_whileloop_solver():
    """≙ test_batched_solver.py::test_batched_matches_whileloop_solver (H =
    100, f64, mu 1e8, 40 iterations, q0 ∈ {−0.4, 0, 0.3}): solve_batched
    against a loop of solve over the lanes: feasible below 1e-7, q_H within
    1e-6 of 3.14, the clean lanes' controls within 1e-4, each lane's cost
    below 1.5× the loop's."""
    problem = pendulum_problem(100)
    params = SolverParams(40, 1e-9, mu=1e8)
    x0s = torch.tensor([[q, 0.0] for q in (-0.4, 0.0, 0.3)], dtype=torch.float64)
    batched = solve_batched(problem, params, x0s)
    ref_us = torch.stack([solve(problem, params, x).us for x in x0s])
    assert float(batched.opt_constr.max()) < 1e-7
    np.testing.assert_allclose(batched.xs[:, -1, 0].numpy(), 3.14, atol=1e-6)
    np.testing.assert_allclose(batched.us[1:].numpy(), ref_us[1:].numpy(), atol=1e-4)
    cost_b = 0.5 * (batched.us**2).sum(dim=(1, 2))
    cost_r = 0.5 * (ref_us**2).sum(dim=(1, 2))
    assert bool((cost_b < 1.5 * cost_r).all())


def test_method_ladder_convergence():
    """≙ test_methods_schedules.py::test_method_ladder_convergence (H = 60,
    f64, mu 1e6, budget 18): every method swings up (q_H within 5e-2,
    opt_constr < 1e-4), and CONSTANT's opt_constr is at most 2× PRIMAL's."""
    problem = pendulum_problem(60)
    res = {m: solve(problem, SolverParams(18, 1e-9, mu=1e6), torch.zeros(2, dtype=torch.float64), method=m)
           for m in Method}  # fmt: skip
    c = {m: float(r.stats.opt_constr) for m, r in res.items()}
    for m, r in res.items():
        np.testing.assert_allclose(float(r.xs[-1, 0]), 3.14, atol=5e-2, err_msg=str(m))
        assert c[m] < 1e-4, (m, c)
    assert c[Method.PRIMAL_DUAL_CONSTANT] <= 2.0 * c[Method.PRIMAL], c


def test_matmul_precision_knob_plumbs_through():
    """≙ test_batched_solver.py::test_matmul_precision_knob_plumbs_through: on
    the CPU matmul_precision="highest" is a bit-exact no-op (H = 100, f32, 3
    iterations, 4 lanes), and solve takes the knob too."""
    problem = pendulum_problem(100, torch.float32)
    params = SolverParams(3, 1e-5, mu=1e4, inner_iters_max=1)
    x0s = torch.tensor([[0.1 * i, 0.0] for i in range(4)])
    r0 = solve_batched(problem, params, x0s)
    r1 = solve_batched(problem, params, x0s, matmul_precision="highest")
    np.testing.assert_array_equal(r0.us.numpy(), r1.us.numpy())
    rs = solve(problem, params, x0s[1], matmul_precision="highest")
    assert bool(torch.isfinite(rs.us).all())
