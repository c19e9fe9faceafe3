"""The port's problem layer against ddp_tpu's, in float64 on the CPU: the
eight derivative checks of tests/test_derivatives.py (each also held to
ddp_tpu's numbers), the manifold Jacobians on the quadrotor and
``all_joints_test_model``, RK4 and second order through the generic path,
the schedules and stacked constraints of tests/test_methods_schedules.py,
``TrajectoryConfigTarget``, the tracking costs, the model identities of
tests/test_model_zoo.py, ``problem_from_numpy`` building both packages'
problems from one numpy spec, and ``pack_problem`` taking the flat-lane
class and refusing what lies outside it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import base as jbase
from ddp_tpu.models.pendulum import pendulum as jpendulum
from ddp_tpu.models.rigid_body import all_joints_test_model as j_all_joints
from ddp_tpu.models.robots import acrobot as jacrobot
from ddp_tpu.models.robots import cartpole as jcartpole
from ddp_tpu.models.robots import panda7 as jpanda7
from ddp_tpu.models.robots import quadrotor as jquadrotor
from ddp_tpu.models.robots import ur5 as jur5
from ddp_tpu.ocp import constraints as jcons
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdyn
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch import SolverParams, solve
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels.flat_problem import pack_problem
from ddp_tpu_torch.models import base as tbase
from ddp_tpu_torch.models import robots as trobots
from ddp_tpu_torch.ocp import constraints, dynamics
from ddp_tpu_torch.ocp.problem import Problem

from torch_parity_helpers import both_robots, spec_of, t, torch_problem

HORIZON = 12
DT = 0.01
F64 = dict(device="cpu", dtype=torch.float64)


def torch_derivs(problem, xs, us):
    """Problem.derivatives of one trajectory (numpy), batch dim dropped."""
    d = problem.derivatives(t(xs)[None], t(us)[None])
    return type(d)(*(f[0] for f in d))


def assert_derivs_match(td, jd, atol, fields=None):
    for f in fields or jd._fields:
        ref = np.asarray(getattr(jd, f))
        got = getattr(td, f).numpy()
        assert got.shape == ref.shape, f
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=f)


# ------------------------------------- tests/test_derivatives.py, the pendulum


@pytest.fixture(scope="module")
def pend():
    """test_derivatives.py's problem (pendulum m 1.3, l 0.7, target 1.5 two
    steps past H = 12, full DDP) in both packages, a numpy-seeded trajectory
    and ddp_tpu's derivatives along it."""
    model = jpendulum(1.3, 0.7, dtype=jnp.float64)
    dyn = jdyn.euler(model, DT)
    con = jcons.advance_time(
        jcons.ConfigTarget(model=model, target=jnp.asarray([1.5]), active_ts=(HORIZON,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64), constraint=con,
                  horizon=HORIZON, second_order=True)  # fmt: skip
    tp = torch_problem(jp)
    rng = np.random.default_rng(0)
    x0, us = 0.3 * rng.standard_normal(2), 0.5 * rng.standard_normal((HORIZON, 1))
    xs = np.asarray(jp.rollout(jnp.asarray(x0), jnp.asarray(us)))
    return jp, tp, xs, us, jax.jit(jp.derivatives)(xs, us)


def test_dynamics_taylor(pend):
    """f(x⊕dx, u+du) ⊖ f(x,u) ≈ fx dx + fu du + ½(dx,du)ᵀH(dx,du), and every
    derivative field as ddp_tpu's."""
    _, tp, xs, us, jd = pend
    d = torch_derivs(tp, xs, us)
    assert_derivs_match(d, jd, atol=1e-12)
    model = tp.model
    eps = 1e-4
    rng = np.random.default_rng(1)
    for k in [0, 3, HORIZON - 1]:
        x, u = t(xs[k]), t(us[k])
        dx, du = t(rng.standard_normal(2) * eps), t(rng.standard_normal(1) * eps)
        f0 = tp.f(k, x, u)
        df = tbase.state_difference(model, f0, tp.f(k, tbase.state_integrate(model, x, dx), u + du))
        lin = d.fx[k] @ dx + d.fu[k] @ du
        quad = 0.5 * (
            torch.einsum("oij,i,j->o", d.fxx[k], dx, dx)
            + 2 * torch.einsum("oij,i,j->o", d.fux[k], du, dx)
            + torch.einsum("oij,i,j->o", d.fuu[k], du, du)
        )
        assert float(torch.linalg.norm(df - lin)) < 10 * eps**2 * max(1, float(torch.linalg.norm(df)) / eps)
        assert float(torch.linalg.norm(df - lin - quad)) < 100 * eps**2 * float(torch.linalg.norm(df))


def test_constraint_taylor(pend):
    _, tp, xs, us, _ = pend
    d = torch_derivs(tp, xs, us)
    k = HORIZON - 2
    mask = tp.eq_mask()
    assert mask[k].all() and not mask[k - 1].any()
    eps = 1e-5
    rng = np.random.default_rng(3)
    x, u = t(xs[k]), t(us[k])
    dx, du = t(rng.standard_normal(2) * eps), t(rng.standard_normal(1) * eps)
    deq = tp.eq(k, tbase.state_integrate(tp.model, x, dx), u + du) - tp.eq(k, x, u)
    assert float(torch.linalg.norm(deq - d.eqx[k] @ dx - d.equ[k] @ du)) < 100 * eps**2
    assert float(d.eq[k - 1].abs().max()) == 0.0 and float(d.eqx[k - 1].abs().max()) == 0.0


def test_cost_derivatives_closed_form(pend):
    """l = ½c‖u‖²: lu = c·u, luu = c·I, lx = 0, lfx = 0."""
    _, tp, xs, us, _ = pend
    d = torch_derivs(tp, xs, us)
    np.testing.assert_allclose(d.lu.numpy(), us, rtol=1e-12)
    np.testing.assert_allclose(d.lx.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(d.luu.numpy(), np.broadcast_to(np.eye(1), d.luu.shape), rtol=1e-12)
    np.testing.assert_allclose(d.lfx.numpy(), 0.0, atol=1e-12)


def test_advance_time_composition_semantics(pend):
    """A double advance evaluates the inner constraint two steps on with the
    same control, as in ddp_tpu."""
    jp, tp, _, _, _ = pend
    k = HORIZON - 2
    x, u = np.array([0.3, -0.2]), np.array([0.7])
    x2 = tp.dynamics(k + 1, tp.dynamics(k, t(x), t(u)), t(u))
    expected = tp.model.difference(t(np.array([1.5])), x2[:1])
    np.testing.assert_allclose(tp.eq(k, t(x), t(u)).numpy(), expected.numpy(), rtol=1e-12)
    np.testing.assert_allclose(tp.eq(k, t(x), t(u)).numpy(), np.asarray(jp.eq(k, x, u)), rtol=1e-12)


def _gn_pair(jmodel, target, horizon=8):
    dyn = jdyn.euler(jmodel, DT)
    con = jcons.advance_time(
        jcons.ConfigTarget(model=jmodel, target=target, active_ts=(horizon,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64), constraint=con,
                  horizon=horizon, second_order=False)  # fmt: skip
    return jp, torch_problem(jp)


def _generic_step_jacobians(tp, x, u):
    """jacfwd over the whole Euler step in tangent coordinates (the
    reference's check of its chain-rule first-order derivatives)."""
    from torch.func import jacfwd

    model, f = tp.model, tp.dynamics
    x1 = f(0, x, u)
    fx = jacfwd(lambda dx: tbase.state_difference(model, x1, f(0, tbase.state_integrate(model, x, dx), u)))(
        torch.zeros(tp.ndx, **F64)
    )
    fu = jacfwd(lambda du: tbase.state_difference(model, x1, f(0, x, u + du)))(torch.zeros(tp.nu, **F64))
    return fx, fu


def test_analytic_euler_jacobians_match_generic_pendulum():
    """The assembled Euler Jacobians equal the generic chart path, and
    ddp_tpu's derivative pass, on the pendulum."""
    jp, tp = _gn_pair(jpendulum(1.3, 0.7, dtype=jnp.float64), jnp.asarray([1.5]))
    assert tp.dynamics.analytic_jacobians_ok
    rng = np.random.default_rng(0)
    us = 0.2 * rng.standard_normal((8, 1))
    xs = tp.rollout(t(0.3 * rng.standard_normal(2)), t(us)).numpy()
    d = torch_derivs(tp, xs, us)
    fx_ref, fu_ref = _generic_step_jacobians(tp, t(xs[0]), t(us[0]))
    np.testing.assert_allclose(d.fx[0].numpy(), fx_ref.numpy(), atol=1e-11)
    np.testing.assert_allclose(d.fu[0].numpy(), fu_ref.numpy(), atol=1e-11)
    assert_derivs_match(d, jp.derivatives(xs, us), atol=1e-12, fields=("fx", "fu", "eqx", "equ"))


def test_analytic_euler_jacobians_match_generic_arm():
    """UR5 (revolute-only, from ddp_tpu's URDF leaves): the assembled
    Jacobians equal jacfwd over the whole step at every step, 1e-9."""
    jarm, arm = both_robots(jur5(dtype=jnp.float64))
    q_t = jarm.integrate(jarm.neutral_configuration(), jnp.asarray(0.05 * np.arange(1.0, 7.0)))
    jp, tp = _gn_pair(jarm, q_t, horizon=4)
    rng = np.random.default_rng(1)
    us = 0.2 * rng.standard_normal((4, 6))
    xs = tp.rollout(t(0.3 * rng.standard_normal(12)), t(us)).numpy()
    d = torch_derivs(tp, xs, us)
    for k in range(4):
        fx_ref, fu_ref = _generic_step_jacobians(tp, t(xs[k]), t(us[k]))
        np.testing.assert_allclose(d.fx[k].numpy(), fx_ref.numpy(), atol=1e-9, err_msg=f"fx {k}")
        np.testing.assert_allclose(d.fu[k].numpy(), fu_ref.numpy(), atol=1e-9, err_msg=f"fu {k}")


@pytest.fixture(scope="module", params=["quadrotor", "all_joints"])
def manifold_case(request):
    """A random configuration, velocity and control (numpy seed) of the
    quadrotor or the spherical/freeflyer/planar test model, in both
    packages, with ddp_tpu's assembled Jacobians there."""
    jm = jquadrotor(dtype=jnp.float64) if request.param == "quadrotor" else j_all_joints(dtype=jnp.float64)
    jm, tm = both_robots(jm)
    rng = np.random.default_rng(3)
    q = np.asarray(jm.integrate(jm.neutral_configuration(), jnp.asarray(rng.uniform(-np.pi, np.pi, jm.nv))))
    x = np.concatenate([q, 0.3 * rng.standard_normal(jm.nv)])
    u = 0.2 * rng.standard_normal(jm.nu)
    jd = jdyn.euler(jm, DT)
    return jm, tm, x, u, jax.jit(jd.jacobians)(0, x, u)


def test_analytic_euler_jacobians_match_generic_manifold(manifold_case):
    """Quaternion/SO(2) configurations take the assembled path too: the
    coordinate ∂a/∂q chained through the chart and the transported q-row
    equal jacfwd over the whole step in tangent coordinates (1e-9), and
    ddp_tpu's assembled Jacobians."""
    _, tm, x, u, (jx1, jfx, jfu) = manifold_case
    dyn = dynamics.euler(tm, DT)
    assert dyn.analytic_jacobians_ok
    x1, fx, fu = dyn.jacobians(0, t(x), t(u))
    np.testing.assert_allclose(x1.numpy(), dyn(0, t(x), t(u)).numpy(), atol=1e-12)
    tp = Problem(dyn, None, constraints.NoConstraint(), 1, second_order=False)
    fx_ref, fu_ref = _generic_step_jacobians(tp, t(x), t(u))
    np.testing.assert_allclose(fx.numpy(), fx_ref.numpy(), atol=1e-9)
    np.testing.assert_allclose(fu.numpy(), fu_ref.numpy(), atol=1e-9)
    np.testing.assert_allclose(fx.numpy(), np.asarray(jfx), atol=1e-9)
    np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), atol=1e-9)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-12)
    # a batch of the same sample gives the same blocks (batched products
    # round differently from 2-D ones)
    _, fxb, _ = dyn.jacobians(0, t(x).expand(3, -1), t(u).expand(3, -1))
    np.testing.assert_allclose(fxb[2].numpy(), fx.numpy(), rtol=0, atol=1e-11)


def test_second_order_analytic_path_matches_generic_arm():
    """Full-DDP Hessians forward over the assembled Jacobian equal the
    generic jacfwd∘jacfwd of the local map on UR5 (1e-12)."""
    jarm, arm = both_robots(jur5(dtype=jnp.float64))
    H = 3
    dyn = dynamics.euler(arm, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(arm, arm.neutral_configuration(), (H,)), dyn, times=2
    )
    from ddp_tpu_torch.ocp import costs as tcosts

    cost = tcosts.quad_control(1.0, **F64)
    prob = Problem(dyn, cost, con, H, second_order=True)

    class GenericEuler(dynamics.EulerDynamics):
        @property
        def analytic_jacobians_ok(self):
            return False

    prob_ref = Problem(GenericEuler(arm, dyn.dt), cost, con, H, second_order=True)
    rng = np.random.default_rng(0)
    x0 = np.concatenate([0.3 * rng.standard_normal(6), 0.2 * rng.standard_normal(6)])
    us = 0.5 * rng.standard_normal((H, 6))
    xs = prob.rollout(t(x0), t(us)).numpy()
    d_fast, d_ref = torch_derivs(prob, xs, us), torch_derivs(prob_ref, xs, us)
    for f in ("fx", "fu", "fxx", "fux", "fuu"):
        np.testing.assert_allclose(getattr(d_fast, f).numpy(), getattr(d_ref, f).numpy(), atol=1e-12, err_msg=f)


# ------------------------------------ generic path: RK4, manifold full DDP


@pytest.fixture(scope="module")
def quad_traj():
    """The quadrotor with a StateTarget two steps past H = 2, a
    numpy-seeded start (tangent perturbation of hover) and controls near
    gravity compensation."""
    jm, tm = both_robots(jquadrotor(dtype=jnp.float64))
    rng = np.random.default_rng(4)
    x_hover = np.asarray(jbase.state_neutral(jm))
    x0 = np.asarray(jbase.state_integrate(jm, jnp.asarray(x_hover), jnp.asarray(0.1 * rng.standard_normal(12))))
    us = np.array([0.0, 0.0, 9.81, 0.0, 0.0, 0.0]) + 0.5 * rng.standard_normal((2, 6))
    q_goal = jm.integrate(jm.neutral_configuration(), jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2]))
    return jm, x0, us, jbase.state_pack(q_goal, jnp.zeros(6))


@pytest.mark.parametrize("disc,second_order", [("euler", True), ("rk4", False)])
def test_generic_derivatives_match_ddp_tpu(quad_traj, disc, second_order):
    """Dynamics without assembled Jacobians (RK4) and full DDP on a
    quaternion configuration take the generic path (coordinate Jacobian of
    the raw next state chained through ⊖, jacfwd∘jacfwd of the local map):
    every field as ddp_tpu's (1e-10), the rollout too."""
    jm, x0, us, x_goal = quad_traj
    H = us.shape[0]
    jd = getattr(jdyn, disc)(jm, 0.02)
    con = jcons.advance_time(jcons.StateTarget(model=jm, target=x_goal, active_ts=(H,)), jd, times=1)
    jp = JProblem(dynamics=jd, cost=jcosts.quad_control(1.0, jnp.float64), constraint=con,
                  horizon=H, second_order=second_order)  # fmt: skip
    tp = torch_problem(jp)
    assert isinstance(tp.dynamics, getattr(dynamics, f"{disc.upper() if disc == 'rk4' else 'Euler'}Dynamics"))
    xs = np.asarray(jp.rollout(jnp.asarray(x0), jnp.asarray(us)))
    np.testing.assert_allclose(tp.rollout(t(x0), t(us)).numpy(), xs, atol=1e-13)
    assert_derivs_match(torch_derivs(tp, xs, us), jax.jit(jp.derivatives)(xs, us), atol=1e-10)


# ------------------------------------------------ schedules and constraints


def test_in_range_schedule_contains():
    s = constraints.in_range(3, 7)
    assert [k for k in range(10) if k in s] == [3, 4, 5, 6]
    p = constraints.every_k(3)
    assert [k for k in range(10) if k in p] == [0, 3, 6, 9]
    p2 = constraints.every_k(3, offset=2)
    assert [k for k in range(10) if k in p2] == [2, 5, 8]
    with pytest.raises(TypeError, match="unbounded"):
        list(p)


def schedules_pair(T=40):
    """test_methods_schedules.py's stacked problem: a path target active
    every 10th step from 20 and a terminal target, in both packages."""
    model = jpendulum(1.0, 1.0, dtype=jnp.float64)
    dyn = jdyn.euler(model, 0.01)
    path = jcons.ConfigTarget(model=model, target=jnp.asarray([0.3]), active_ts=jcons.every_k(10, offset=20))
    terminal = jcons.advance_time(
        jcons.ConfigTarget(model=model, target=jnp.asarray([0.3]), active_ts=(T,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64),
                  constraint=jcons.StackConstraints(parts=(path, terminal)), horizon=T)  # fmt: skip
    return jp, torch_problem(jp)


def test_every_k_and_in_range_schedules():
    """≙ test_methods_schedules.py::test_every_k_and_in_range_schedules: the
    per-row mask of the stack, and the solve meeting the path target at its
    scheduled steps — the same solve as ddp_tpu's."""
    T = 40
    jp, tp = schedules_pair(T)
    assert isinstance(tp.constraint, constraints.StackConstraints)
    mask = tp.eq_mask()
    np.testing.assert_array_equal(mask, jp.eq_mask())
    assert list(np.nonzero(mask[:, 0])[0]) == [20, 30]
    assert list(np.nonzero(mask[:, 1])[0]) == [T - 2]
    kw = dict(max_iterations=60, threshold=1e-8, mu=1e6)
    res = solve(tp, SolverParams(**kw), torch.zeros(2, **F64))
    assert float(res.stats.opt_constr) < 1e-6
    for k in (20, 30, T):
        np.testing.assert_allclose(float(res.xs[k, 0]), 0.3, atol=1e-4)
    rj = jax.jit(lambda x: jsolve(jp, JParams(**kw), x))(jnp.zeros(2))
    np.testing.assert_allclose(res.us.numpy(), np.asarray(rj.us), rtol=0, atol=1e-6 * max(1, np.abs(np.asarray(rj.us)).max()))


def test_eq_all_and_derivatives_of_the_stack():
    """Problem.eq_all (active steps only, masked per row) and the stacked
    constraint's derivative rows as ddp_tpu's."""
    jp, tp = schedules_pair()
    rng = np.random.default_rng(5)
    us = 0.5 * rng.standard_normal((40, 1))
    xs = np.asarray(jp.rollout(jnp.asarray([0.1, 0.0]), jnp.asarray(us)))
    eq = tp.eq_all(t(xs), t(us))
    np.testing.assert_allclose(eq.numpy(), np.asarray(jp.eq_all(xs, us)), atol=1e-13)
    assert float(eq[21].abs().max()) == 0.0 and float(eq[20, 0].abs()) > 0
    eq_b = tp.eq_all(t(xs)[None].expand(2, -1, -1), t(us)[None].expand(2, -1, -1))
    assert eq_b.shape == (2, 40, 2) and torch.equal(eq_b[1], eq)
    assert_derivs_match(torch_derivs(tp, xs, us), jax.jit(jp.derivatives)(xs, us), atol=1e-12,
                        fields=("eq", "eqx", "equ", "eqxx", "equx", "equu"))  # fmt: skip


def test_trajectory_config_target():
    """≙ test_aux_subsystems.py::test_trajectory_config_target: the
    per-step gather, t clamped into range."""
    T = 10
    from ddp_tpu_torch.models.pendulum import pendulum

    pm = pendulum(**F64)
    targets = torch.linspace(0.0, 1.0, T + 1, dtype=torch.float64)[:, None]
    con = constraints.TrajectoryConfigTarget(pm, targets, tuple(range(0, T, 2)))
    x = torch.tensor([0.25, 0.0], **F64)
    np.testing.assert_allclose(float(con.value(5, x, torch.zeros(1, **F64))[0]), 0.25 - 0.5, atol=1e-12)
    assert con.active(2) and not con.active(3)
    np.testing.assert_allclose(float(con.value(40, x, torch.zeros(1, **F64))[0]), 0.25 - 1.0, atol=1e-12)
    vals = con.value(torch.tensor([0, 5, 99]), x.expand(3, 2), torch.zeros(3, 1, **F64))
    np.testing.assert_allclose(vals[:, 0].numpy(), [0.25, -0.25, -0.75], atol=1e-12)


def test_one_numpy_spec_builds_both_problems():
    """problem_from_numpy reads a spec holding every new piece — RK4, a
    stack of a TrajectoryConfigTarget under AdvanceTime on an in_range
    schedule and a StateTarget on an every_k schedule, a tracking cost — and
    builds the problem ddp_tpu has: same mask, rollout and derivatives."""
    T = 6
    model = jpendulum(1.1, 0.9, dtype=jnp.float64)
    dyn = jdyn.rk4(model, 0.05)
    track = jcons.advance_time(
        jcons.TrajectoryConfigTarget(model=model, targets=jnp.linspace(0.0, 0.6, T + 2)[:, None],
                                     active_ts=jcons.in_range(2, 5)),
        dyn, times=1,
    )  # fmt: skip
    rest = jcons.StateTarget(model=model, target=jnp.asarray([0.4, 0.0]), active_ts=jcons.every_k(3, offset=1))
    cost = jcosts.QuadTrackingCost(x_ref=jnp.asarray([0.5, 0.0]), q_diag=jnp.asarray([2.0, 0.1]),
                                   r_diag=jnp.asarray([0.3]), qf_diag=jnp.asarray([5.0, 1.0]))  # fmt: skip
    jp = JProblem(dynamics=dyn, cost=cost, constraint=jcons.StackConstraints(parts=(track, rest)),
                  horizon=T, second_order=True)  # fmt: skip
    spec = spec_of(jp)
    assert spec["discretization"] == "rk4" and spec["constraint"]["kind"] == "stack"
    tp = problem_from_numpy(spec, **F64)
    assert isinstance(tp.dynamics, dynamics.RK4Dynamics)
    np.testing.assert_array_equal(tp.eq_mask(), jp.eq_mask())
    rng = np.random.default_rng(6)
    us = 0.4 * rng.standard_normal((T, 1))
    xs = np.asarray(jp.rollout(jnp.asarray([0.2, -0.1]), jnp.asarray(us)))
    np.testing.assert_allclose(tp.rollout(t(xs[0]), t(us)).numpy(), xs, atol=1e-13)
    assert_derivs_match(torch_derivs(tp, xs, us), jax.jit(jp.derivatives)(xs, us), atol=1e-11)


@pytest.mark.parametrize("which", ["quad_tracking", "manifold_tracking"])
def test_tracking_costs_match_ddp_tpu(which):
    """Both tracking costs' values and derivatives as ddp_tpu's; the
    manifold one on the quadrotor's quaternion state."""
    if which == "quad_tracking":
        jm = jpendulum(1.0, 1.0, dtype=jnp.float64)
        cost = jcosts.QuadTrackingCost(x_ref=jnp.asarray([1.0, 0.5]), q_diag=jnp.asarray([2.0, 0.5]),
                                       r_diag=jnp.asarray([0.1]), qf_diag=jnp.asarray([10.0, 1.0]))  # fmt: skip
        x = np.array([0.3, -0.2])
        u = np.array([0.7])
    else:
        jm = jquadrotor(dtype=jnp.float64)
        x_ref = jbase.state_pack(jm.integrate(jm.neutral_configuration(), jnp.asarray([0.1, 0.2, 0.3, 0.2, -0.1, 0.3])),
                                 jnp.zeros(6))  # fmt: skip
        cost = jcosts.ManifoldTrackingCost(
            model=jm, x_ref=x_ref, q_diag=jnp.arange(1.0, 7.0), v_diag=jnp.full(6, 0.5),
            r_diag=jnp.full(6, 0.01), terminal_scale=jnp.asarray(3.0),
        )  # fmt: skip
        rng = np.random.default_rng(7)
        x = np.asarray(jbase.state_integrate(jm, jbase.state_neutral(jm), jnp.asarray(0.4 * rng.standard_normal(12))))
        u = rng.standard_normal(6)
    dyn = jdyn.euler(jm, 0.01)
    jp = JProblem(dynamics=dyn, cost=cost, constraint=jcons.NoConstraint(), horizon=1, second_order=False)
    tp = torch_problem(jp)
    np.testing.assert_allclose(float(tp.l(0, t(x), t(u))), float(jp.l(0, x, u)), rtol=1e-13)
    np.testing.assert_allclose(float(tp.lf(t(x))), float(jp.lf(x)), rtol=1e-13)
    xs = np.stack([x, np.asarray(jp.f(0, x, u))])
    assert_derivs_match(torch_derivs(tp, xs, u[None]), jax.jit(jp.derivatives)(xs, u[None]), atol=1e-11,
                        fields=("lx", "lu", "lxx", "lux", "luu", "lfx", "lfxx"))  # fmt: skip


def _flat_cases():
    """Problems of the pendulum at T = 8 built from the port's constructors,
    each with one part of the flat-lane class that PRs before the class was
    widened refused."""
    from ddp_tpu_torch.models.pendulum import pendulum
    from ddp_tpu_torch.ocp import costs as tcosts

    pm = pendulum(**F64)
    euler = dynamics.euler(pm, 0.01)
    quad = tcosts.quad_control(1.0, **F64)
    target = constraints.ConfigTarget(pm, torch.tensor([1.0], **F64), (8,))
    other_dt = dynamics.euler(pm, 0.02)
    return {
        "RK4Dynamics": Problem(dynamics.rk4(pm, 0.01), quad, target, 8),
        "StateTarget": Problem(euler, quad, constraints.StateTarget(pm, torch.zeros(2, **F64), (8,)), 8),
        "TrajectoryConfigTarget": Problem(
            euler, quad, constraints.TrajectoryConfigTarget(pm, torch.zeros(9, 1, **F64), (4,)), 8
        ),
        "StackConstraints": Problem(euler, quad, constraints.StackConstraints((target,)), 8),
        "every_k": Problem(euler, quad, constraints.ConfigTarget(pm, torch.ones(1, **F64), constraints.every_k(2)), 8),
        "in_range": Problem(
            euler, quad, constraints.ConfigTarget(pm, torch.ones(1, **F64), constraints.in_range(2, 4)), 8
        ),
        "QuadTrackingCost": Problem(
            euler, tcosts.QuadTrackingCost(torch.zeros(2, **F64), torch.ones(2, **F64),
                                           torch.ones(1, **F64), torch.ones(2, **F64)), target, 8,
        ),  # fmt: skip
        "AdvanceTime_own_dt": Problem(euler, quad, constraints.advance_time(target, other_dt, 2), 8),
    }


@pytest.mark.parametrize("case", list(_flat_cases()))
def test_pack_problem_takes_the_new_classes(case):
    """The flat-lane packer takes each class that ddp_tpu's flat kernels
    take: the buffer's spec builds a problem that packs to the same buffer,
    mask and structure, and the mask is the problem's."""
    problem = _flat_cases()[case]
    flat = pack_problem(problem)
    assert flat.e == problem.ne and flat.build["E"] == problem.ne
    assert flat.build["DYN"] == (case == "RK4Dynamics") and flat.build["COST"] == (case == "QuadTrackingCost")
    np.testing.assert_array_equal(flat.mask.numpy(), problem.eq_mask())
    again = pack_problem(problem_from_numpy(flat.spec(), **F64))
    assert torch.equal(again.consts, flat.consts) and again.tree == flat.tree
    assert torch.equal(again.mask, flat.mask) and again.leaves == flat.leaves
    assert sum(len(layers) for _, layers in flat.leaves) == (2 if case == "AdvanceTime_own_dt" else 0)


def _refused_cases():
    from ddp_tpu_torch.models.pendulum import pendulum
    from ddp_tpu_torch.ocp import costs as tcosts

    pm, cart = pendulum(**F64), trobots.cartpole(**F64)
    quad = tcosts.quad_control(1.0, **F64)
    target = constraints.ConfigTarget(pm, torch.tensor([1.0], **F64), (8,))
    cart_euler = dynamics.euler(cart, 0.01)
    return {
        "RobotModel": (
            Problem(cart_euler, quad, constraints.ConfigTarget(cart, torch.zeros(2, **F64), (8,)), 8),
            "a RobotModel model",
        ),
        "FrameTarget": (
            Problem(cart_euler, quad, constraints.FrameTarget(cart, torch.zeros(3, **F64), 0, (8,)), 8),
            "FrameTarget on a RobotModel",
        ),
        "AdvanceTime_over_RobotModel": (
            Problem(dynamics.euler(pm, 0.01), quad, constraints.AdvanceTime(target, cart_euler), 8),
            "an AdvanceTime layer over a RobotModel's dynamics",
        ),
    }


@pytest.mark.parametrize("case", list(_refused_cases()))
def test_pack_problem_refuses_what_ddp_tpu_refuses(case):
    """What ddp_tpu's flat kernels refuse (a RobotModel captures constants)
    raises ValueError naming the part."""
    problem, reason = _refused_cases()[case]
    with pytest.raises(ValueError, match=f"{reason} is not in the flat-lane class"):
        pack_problem(problem)


# ----------------------------------------------- tests/test_model_zoo.py


@pytest.mark.parametrize("name,nv", [("panda7", 7), ("cartpole", 2), ("acrobot", 2), ("quadrotor", 6)])
def test_dynamics_identities(name, nv):
    """≙ test_model_zoo.py::test_dynamics_identities: RNEA inverts the
    forward dynamics and M is SPD, on ddp_tpu's model carried over."""
    ctor = {"panda7": jpanda7, "cartpole": jcartpole, "acrobot": jacrobot, "quadrotor": jquadrotor}[name]
    jm, m = both_robots(ctor(dtype=jnp.float64))
    assert m.nv == nv
    q = m.random_configuration(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    v, tau = t(0.5 * rng.standard_normal(nv)), t(rng.standard_normal(nv))
    a = m.forward_dynamics(q, v, tau)
    np.testing.assert_allclose(m.rnea(q, v, a).numpy(), tau.numpy(), atol=1e-8)
    M = m.mass_matrix(q).numpy()
    assert np.all(np.linalg.eigvalsh(0.5 * (M + M.T)) > 0)
    np.testing.assert_allclose(a.numpy(), np.asarray(jm.forward_dynamics(q.numpy(), v.numpy(), tau.numpy())), atol=1e-9)


def test_quadrotor_freefall():
    """The unforced quadrotor accelerates at −g along world z."""
    m = trobots.quadrotor(**F64)
    a = m.forward_dynamics(m.neutral_configuration(), torch.zeros(6, **F64), torch.zeros(6, **F64))
    np.testing.assert_allclose(a[:3].numpy(), [0.0, 0.0, -9.81], atol=1e-10)
    np.testing.assert_allclose(a[3:].numpy(), 0.0, atol=1e-10)
