"""ddp_tpu_torch.solve, the single-trajectory entry point, against ddp_tpu's
solve and the reference's own artifacts, in float64 on the CPU: the committed
golden controls (tests/test_reference_parity.py's bars), the f64 oracle step
for step with ``reference_schedule=True``, the three methods and iLQR mode,
the recorded decision sequence (tests/test_history.py's configuration), the
multiplier and penalty safeguards, and the quadrotor's constrained solve
(tests/test_model_zoo.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import base as jbase
from ddp_tpu.models.robots import quadrotor as jquadrotor
from ddp_tpu.ocp import constraints as jcons
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdyn
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.solver.solve import Method as JMethod
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch import Method, SolverParams, pendulum, solve
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.solver import al as tal
from tests.reference_oracle import solve_pendulum_reference

from torch_parity_helpers import jax_pendulum_problem, spec_of, t, torch_problem

GOLDEN = Path(__file__).resolve().parent / "golden_pendulum_reference.npz"
F64 = dict(device="cpu", dtype=torch.float64)


def pendulum_pair(horizon, second_order=True):
    """The reference's pendulum problem (target 3.14 two steps past the
    horizon, dt = 0.01, ½‖u‖²) in both packages, f64."""
    jp = jax_pendulum_problem(horizon, jnp.float64, second_order=second_order)
    return jp, torch_problem(jp)


def gate_seq(history, k):
    """The first k rows' multiplier-update decisions."""
    s, f = history.upd_success, history.upd_failure
    return ["success" if bool(s[i]) else "failure" if bool(f[i]) else "none" for i in range(k)]


def test_package_exports_match_ddp_tpu():
    """``from ddp_tpu_torch import solve, pendulum`` as from ddp_tpu, where
    ``pendulum`` is the model's module."""
    import ddp_tpu
    import ddp_tpu_torch

    assert sorted(ddp_tpu_torch.__all__) == sorted(ddp_tpu.__all__)
    assert ddp_tpu.pendulum.__name__.split(".")[-1] == pendulum.__name__.split(".")[-1] == "pendulum"
    m = pendulum.pendulum(**F64)
    assert (m.nq, m.nv, m.nu) == (1, 1, 1) and m.mass.dtype == torch.float64


# ------------------------------------------------------------- the golden run


@pytest.fixture(scope="module")
def golden_run():
    _, tp = pendulum_pair(200)
    return solve(tp, SolverParams(max_iterations=200, threshold=1e-9, mu=1e8), torch.zeros(2, **F64))


def test_solve_matches_reference_golden_controls(golden_run):
    """≙ test_reference_parity.py::test_solve_matches_reference_golden_controls:
    horizon 200, ≤ 200 iterations, the MPFR-analog golden controls."""
    g = np.load(GOLDEN)
    res = golden_run
    assert bool(res.stats.converged)
    assert int(res.stats.iterations) <= 200
    du = np.abs(res.us.numpy() - g["us"]).max()
    dx = np.abs(res.xs.numpy() - g["xs"]).max()
    assert du < 1e-9, du
    assert dx < 1e-11, dx


def test_golden_run_meets_the_constraint(golden_run):
    """≙ test_pendulum_solve.py::test_constraint_satisfied_exactly_at_optimum
    on the golden run: the masked residual of ``Problem.eq_all``."""
    _, tp = pendulum_pair(200)
    eq = tp.eq_all(golden_run.xs, golden_run.us)
    assert eq.shape == (200, 1) and float(eq.abs().max()) < 1e-6
    assert abs(float(golden_run.xs[-1, 0]) - 3.14) < 1e-5


# ------------------------------------------------ the reference, step for step


def test_reference_schedule_stepwise_parity():
    """≙ test_reference_parity.py::test_reference_schedule_stepwise_parity:
    solve(reference_schedule=True) tracks the f64 oracle within 1e-10 through
    8 outer iterations from a random multiplier jac."""
    rng = np.random.RandomState(0)
    jac_row = rng.uniform(-1, 1, size=(2,))
    iters, mu0 = 8, 1e4
    res_o = solve_pendulum_reference(mu_init=mu0, max_iterations=iters, threshold=1e-300, jac_init=jac_row)
    _, tp = pendulum_pair(200)
    jac_init = np.zeros((200, 1, 2))
    jac_init[198, 0] = jac_row
    res = solve(
        tp, SolverParams(max_iterations=iters, threshold=1e-300, mu=mu0), torch.zeros(2, **F64),
        method=Method.PRIMAL_DUAL_AFFINE, mults_init_jac=t(jac_init), reference_schedule=True,
    )  # fmt: skip
    assert np.abs(res.us.numpy() - np.asarray(res_o["us"], np.float64)).max() < 1e-10
    assert np.abs(res.xs.numpy() - np.asarray(res_o["xs"], np.float64)).max() < 1e-10
    assert float(res.stats.mu) == pytest.approx(float(res_o["mu"]))
    assert float(res.stats.opt_obj) == pytest.approx(float(res_o["opt_obj"]), rel=1e-6)


# ------------------------------------------------- against ddp_tpu's solve


@pytest.fixture(scope="module")
def method_runs():
    """Both packages' solves of test_methods_schedules.py's problem (horizon
    60, μ₀ = 1e6, 25 iterations) for every method, and in iLQR mode."""
    out = {}
    for so in (True, False):
        jp, tp = pendulum_pair(60, second_order=so)
        for m, jm in zip(Method, JMethod):
            if not so and m is not Method.PRIMAL_DUAL_AFFINE:
                continue
            kw = dict(max_iterations=25, threshold=1e-9, mu=1e6)
            rj = jax.jit(lambda x, jm=jm: jsolve(jp, JParams(**kw), x, method=jm))(jnp.zeros(2))
            rt = solve(tp, SolverParams(**kw), torch.zeros(2, **F64), method=m)
            out[m.value if so else "ilqr"] = (rj, rt)
    return out


@pytest.mark.parametrize("which", [m.value for m in Method] + ["ilqr"])
def test_solve_matches_ddp_tpu(method_runs, which):
    """The same optimum as ddp_tpu's solve in the same iterations: us and xs
    within 1e-7 of their scale, both feasible, the same iteration count and
    convergence; a constant method's multipliers have no state feedback."""
    rj, rt = method_runs[which]
    for f in ("us", "xs"):
        ref = np.asarray(getattr(rj, f))
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(getattr(rt, f).numpy(), ref, rtol=0, atol=1e-7 * scale, err_msg=f)
    assert int(rt.stats.iterations) == int(rj.stats.iterations)
    assert bool(rt.stats.converged) == bool(rj.stats.converged)
    bar = 1e-4 if which == "ilqr" else 1e-6
    assert float(rt.stats.opt_constr) < bar and float(rj.stats.opt_constr) < bar
    if which not in (Method.PRIMAL_DUAL_AFFINE.value, "ilqr"):
        assert float(rt.mults.jac.abs().max()) == 0.0


def test_primal_method_distinct_from_constant(method_runs):
    """≙ test_methods_schedules.py::test_primal_method_distinct_from_constant."""
    rp = method_runs[Method.PRIMAL.value][1]
    rc = method_runs[Method.PRIMAL_DUAL_CONSTANT.value][1]
    assert float(rp.mults.jac.abs().max()) == 0.0 and float(rc.mults.jac.abs().max()) == 0.0
    assert float((rp.mults.val - rc.mults.val).abs().max()) > 0.0


# ------------------------------------------------------------- the history


@pytest.fixture(scope="module")
def history_runs():
    """test_history.py's solve (horizon 100, μ₀ = 1e6, 40 iterations) in both
    packages with history, and the port's without."""
    jp, tp = pendulum_pair(100)
    kw = dict(max_iterations=40, threshold=1e-9, mu=1e6)
    rj = jax.jit(lambda x: jsolve(jp, JParams(**kw), x, history=True))(jnp.zeros(2))
    rh = solve(tp, SolverParams(**kw), torch.zeros(2, **F64), history=True)
    rw = solve(tp, SolverParams(**kw), torch.zeros(2, **F64))
    return SolverParams(**kw), rj, rh, rw


# Rows on which ddp_tpu agrees with itself run jitted and op by op
# (jax.disable_jit), measured on the CPU by tests/test_torch_reference_draws.py
# (jit_vs_eager; the reference-schedule rows likewise): on test_history.py's solve the gate
# outcomes part at row 18 (μ 1e11 → 1e12) and the accepted steps at row 9,
# whose line search weighs a full-step cost change of ±2e-12 on a cost of
# 4497; on the reference-schedule solve from μ₀ = 1e4 both part at row 10.
# Past them a decision is decided by roundoff, in either package.
HISTORY_ROWS_RESOLVED, HISTORY_STEPS_RESOLVED = 18, 9
REFERENCE_ROWS_RESOLVED = 10


def test_history_decision_sequence_matches_ddp_tpu(history_runs):
    """Every gate outcome and μ as ddp_tpu records them on the rows f64
    resolves, and the accepted steps before the first noise-level line
    search."""
    _, rj, rh, _ = history_runs
    n, k = HISTORY_ROWS_RESOLVED, HISTORY_STEPS_RESOLVED
    assert gate_seq(rh.history, n) == gate_seq(rj.history, n)
    assert "success" in gate_seq(rh.history, n) and "failure" in gate_seq(rh.history, n)
    np.testing.assert_array_equal(rh.history.mu[:n].numpy(), np.asarray(rj.history.mu)[:n])
    assert rh.history.step[:k].tolist() == np.asarray(rj.history.step)[:k].tolist()


def test_reference_schedule_decision_sequence_matches_ddp_tpu():
    """≙ test_reference_parity.py::test_decision_sequence_parity_vs_mpmath_oracle's
    μ₀ = 1e4 run, held to ddp_tpu: gate outcomes, accepted steps and μ on
    the rows f64 resolves, the first multiplier update among them."""
    rng = np.random.RandomState(0)
    jac_row = rng.uniform(-1, 1, size=(2,))
    jac_init = np.zeros((200, 1, 2))
    jac_init[198, 0] = jac_row
    jp, tp = pendulum_pair(200)
    n = REFERENCE_ROWS_RESOLVED
    kw = dict(max_iterations=n, threshold=1e-300, mu=1e4)
    rj = jax.jit(
        lambda x: jsolve(jp, JParams(**kw), x, mults_init_jac=jnp.asarray(jac_init),
                         reference_schedule=True, history=True)
    )(jnp.zeros(2))  # fmt: skip
    rt = solve(tp, SolverParams(**kw), torch.zeros(2, **F64), mults_init_jac=t(jac_init),
               reference_schedule=True, history=True)  # fmt: skip
    assert gate_seq(rt.history, n) == gate_seq(rj.history, n)
    assert gate_seq(rt.history, n).count("success") == 1
    assert rt.history.step.tolist() == np.asarray(rj.history.step).tolist()
    np.testing.assert_array_equal(rt.history.mu.numpy(), np.asarray(rj.history.mu))
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), rtol=0, atol=1e-10)


def test_history_matches_schedule_decision_tree(history_runs):
    """≙ test_history.py::test_history_matches_schedule_decision_tree."""
    params, _, res, _ = history_runs
    h = res.history
    mu, w, n, step = (getattr(h, f).numpy() for f in ("mu", "w", "n", "step"))
    upd_s, upd_f, done = (getattr(h, f).numpy() for f in ("upd_success", "upd_failure", "done"))
    assert mu.shape == (params.max_iterations,)
    live = ~done
    assert np.any(upd_s), "schedule never fired a multiplier update"
    assert np.all(step[live] > 0) and np.all(step[live] <= 1.0)
    mu_prev = np.concatenate([[params.mu], mu[:-1]])
    assert np.all(mu >= mu_prev * (1 - 1e-12))
    fail_rows = np.where(upd_f)[0]
    assert np.all(mu[fail_rows] >= 10.0 * mu_prev[fail_rows] * (1 - 1e-12))
    w_prev = np.concatenate([[1.0 / params.mu], w[:-1]])
    n_prev = np.concatenate([[params.mu**-0.1], n[:-1]])
    succ = np.where(upd_s)[0]
    assert np.allclose(w[succ], w_prev[succ] / mu_prev[succ], rtol=1e-12)
    assert np.allclose(n[succ], np.maximum(n_prev[succ] * mu_prev[succ] ** -0.9, params.threshold), rtol=1e-9)
    assert not np.any(np.logical_and(upd_s, upd_f))
    assert np.all(done == np.logical_or.accumulate(done))
    if done.any():
        j = int(done.argmax())
        assert int(res.stats.iterations) == j + 1
        assert bool(res.stats.converged)
        assert np.all(mu[j:] == mu[j])
        assert not np.any(upd_s[j:]) and not np.any(upd_f[j:])


def test_history_path_matches_while_loop_path(history_runs):
    """≙ test_history.py::test_history_path_matches_while_loop_path."""
    _, _, rh, rw = history_runs
    assert rw.history is None
    np.testing.assert_allclose(rh.us.numpy(), rw.us.numpy(), rtol=0, atol=1e-13)
    assert int(rh.stats.iterations) == int(rw.stats.iterations)
    assert float(rh.stats.opt_constr) == float(rw.stats.opt_constr)
    done = rh.history.done.numpy()
    j = int(done.argmax()) if done.any() else len(done) - 1
    assert float(rh.history.opt_constr[j]) == float(rw.stats.opt_constr)


# ------------------------------------------------------------ the safeguards


def test_random_multiplier_jac_init_converges_identically():
    """≙ test_methods_schedules.py::test_random_multiplier_jac_init_converges_identically,
    the random jac from a numpy seed."""
    _, tp = pendulum_pair(60)
    params = SolverParams(max_iterations=30, threshold=1e-9, mu=1e6)
    x0 = torch.zeros(2, **F64)
    res_zero = solve(tp, params, x0)
    jac0 = t(0.5 * np.random.default_rng(0).standard_normal((60, 1, 2)))
    xs0 = tp.rollout(x0, torch.zeros(60, 1, **F64))
    assert float(tal.init_multipliers(tp, xs0, jac_init=jac0).jac.abs().max()) > 0.0
    res_rand = solve(tp, params, x0, mults_init_jac=jac0)
    np.testing.assert_allclose(float(res_rand.xs[-1, 0]), float(res_zero.xs[-1, 0]), atol=1e-6)
    np.testing.assert_allclose(res_rand.us.numpy(), res_zero.us.numpy(), atol=1e-5)
    assert float(res_rand.stats.opt_constr) < 1e-6


def test_mu_factor_cap_and_mult_safeguard():
    """≙ test_methods_schedules.py::test_mu_factor_cap_and_mult_safeguard."""
    _, tp = pendulum_pair(60)
    params = SolverParams(
        max_iterations=40, threshold=1e-9, mu=1e4, mu_factor=3.0, mu_max=1e7, mult_max=1e4
    )
    res = solve(tp, params, torch.zeros(2, **F64), history=True)
    assert float(res.stats.opt_constr) < 1e-6
    assert float(res.history.mu.max()) <= 1e7 + 1e-6
    assert float(res.mults.val.abs().max()) <= 1e4 + 1e-9


def test_precise_modes_raise_and_bad_inputs_raise_alike():
    """precise=True|"storage" names the precision envelope still to port; a
    bad x_init raises the same AssertionError in both packages."""
    jp, tp = pendulum_pair(8)
    params = SolverParams(max_iterations=2, threshold=1e-9, mu=1e4)
    for precise in (True, "storage"):
        with pytest.raises(NotImplementedError, match="precision envelope"):
            solve(tp, params, torch.zeros(2, **F64), precise=precise)
    raised = []
    for fn, p, x in ((jsolve, jp, jnp.zeros(3)), (solve, tp, torch.zeros(3, **F64))):
        with pytest.raises(AssertionError) as exc:
            fn(p, JParams(*params) if fn is jsolve else params, x)
        raised.append(str(exc.value).split("\n", 1)[1])
    assert raised[0] == raised[1] and "[FAILED]" in raised[0]
    with pytest.raises(ValueError, match="float32"):
        solve(tp, params, torch.zeros(2, dtype=torch.float32))


# ------------------------------------------------------------- the quadrotor


def quadrotor_pair(horizon):
    """test_model_zoo.py's quadrotor problem (Euler dt = 0.02, a StateTarget
    at q0 ⊕ (0.3, −0.2, 0.4, 0, 0, 0.2) at rest two steps past the horizon,
    ½‖u‖², Gauss-Newton) in both packages from one numpy spec."""
    quad = jquadrotor(dtype=jnp.float64)
    dyn = jdyn.euler(quad, 0.02)
    q0 = quad.neutral_configuration()
    q_goal = quad.integrate(q0, jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2], jnp.float64))
    x_goal = jbase.state_pack(q_goal, jnp.zeros(6, jnp.float64))
    con = jcons.advance_time(jcons.StateTarget(model=quad, target=x_goal, active_ts=(horizon,)), dyn, times=2)
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, jnp.float64), constraint=con,
                  horizon=horizon, second_order=False)  # fmt: skip
    return jp, problem_from_numpy(spec_of(jp), **F64)


def test_quadrotor_constrained_solve_end_to_end():
    """≙ test_model_zoo.py::test_quadrotor_constrained_solve_end_to_end: the
    freeflyer's 12-row terminal state constraint through the manifold
    Jacobians, from a gravity-compensation warm start; the same-u prediction
    reaches the goal."""
    H = 24
    jp, tp = quadrotor_pair(H)
    quad = tp.model
    q0 = quad.neutral_configuration()
    zero_v = torch.zeros(6, **F64)
    us0 = quad.rnea(q0, zero_v, zero_v)[None].repeat(H, 1)
    params = SolverParams(max_iterations=40, threshold=1e-8, mu=1e4, inner_iters_max=3)
    res = solve(tp, params, torch.cat([q0, zero_v]), us_init=us0)
    assert float(res.stats.opt_constr) < 1e-3
    dyn = tp.dynamics
    x_pred = dyn(H - 1, dyn(H - 2, res.xs[H - 2], res.us[H - 2]), res.us[H - 2])
    q_goal = tp.constraint.inner.inner.target[:7]
    np.testing.assert_allclose(x_pred[:3].numpy(), q_goal[:3].numpy(), atol=1e-3)
    np.testing.assert_allclose(x_pred[7:].numpy(), 0.0, atol=1e-3)
    qn = torch.linalg.vector_norm(res.xs[:, 3:7], dim=-1)
    assert float((qn - 1).abs().max()) < 1e-10
