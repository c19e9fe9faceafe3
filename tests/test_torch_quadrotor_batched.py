"""solve_batched on the quadrotor row's recipe (bench.py's quaternion-manifold
row, cut to B = 4, H = 8) against ddp_tpu's, and the two batched riders of
tests/test_batched_solver.py, on the CPU."""

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
from ddp_tpu.solver.batched import solve_batched as jsolve_batched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.solve import SolverParams

from torch_parity_helpers import jax_pendulum_problem, spec_of, t, torch_problem

B, H = 4, 8
# the row's recipe (bench.py's quadrotor row) at 6 iterations
RECIPE = dict(max_iterations=6, threshold=1e-5, mu=1e4, inner_iters_max=3)
RECIPE_KW = dict(n_linesearch=8, forward="seq", matmul_precision="highest")


def quadrotor_inputs(jm, np_dtype):
    """The row's start states (q0 ⊕ 0.05·N(0, 1) from default_rng(0), at
    rest) and gravity-compensation controls, as numpy."""
    rng = np.random.default_rng(0)
    x0 = jbase.state_neutral(jm)
    dxs = 0.05 * rng.standard_normal((B, 12))
    x0s = np.stack([np.asarray(jbase.state_integrate(jm, x0, jnp.asarray(d))) for d in dxs])
    zero_v = jnp.zeros(6, jm.dtype)
    grav = np.stack([np.asarray(jm.rnea(jnp.asarray(x[:7]), zero_v, zero_v)) for x in x0s])
    return x0s.astype(np_dtype), np.tile(grav[:, None, :], (1, H, 1)).astype(np_dtype)


@pytest.fixture(scope="module")
def quad_row():
    """The row's problem (Euler dt = 0.02, a StateTarget at
    q0 ⊕ (0.3, −0.2, 0.4, 0, 0, 0.2) at rest two steps past the horizon,
    ½‖u‖², Gauss-Newton) in both packages from one numpy spec, f64, and
    ddp_tpu's solve of it."""
    jm = jquadrotor(dtype=jnp.float64)
    dyn = jdyn.euler(jm, 0.02)
    q_goal = jm.integrate(jm.neutral_configuration(), jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2]))
    con = jcons.advance_time(
        jcons.StateTarget(model=jm, target=jbase.state_pack(q_goal, jnp.zeros(6)), active_ts=(H,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, jnp.float64), constraint=con,
                  horizon=H, second_order=False)  # fmt: skip
    tp = problem_from_numpy(spec_of(jp), device="cpu", dtype=torch.float64)
    x0s, us0 = quadrotor_inputs(jm, np.float64)
    rj = jax.jit(
        lambda x, u: jsolve_batched(jp, JParams(**RECIPE), x, us_init=u, backward="sweep", **RECIPE_KW)
    )(x0s, us0)
    return tp, x0s, us0, rj


@pytest.mark.parametrize("backward", ["sweep", "kernel"])
def test_quadrotor_solve_batched_matches_ddp_tpu(quad_row, backward):
    """deriv="jvp" (the manifold Jacobians) with the sweep backward, or the
    Riccati kernel's plain version at (12, 6, 12): us within 1e-7 of each
    lane's largest |u|, identical μ, unit quaternions."""
    tp, x0s, us0, rj = quad_row
    assert (tp.ndx, tp.nu, tp.ne) == (12, 6, 12) and rs.instantiation(12, 6, 12)["SO"] == 0
    before = rs.LAUNCHES
    res = solve_batched(tp, SolverParams(**RECIPE), t(x0s), us_init=t(us0), deriv="jvp",
                        backward=backward, **RECIPE_KW)  # fmt: skip
    assert rs.LAUNCHES == before  # CPU tensors take the plain version
    ref = np.asarray(rj.us)
    scale = np.maximum(np.abs(ref).max(axis=(1, 2)), 1.0)
    err = (np.abs(res.us.numpy() - ref).max(axis=(1, 2)) / scale).max()
    assert err < 1e-7, err
    np.testing.assert_array_equal(res.mu.numpy(), np.asarray(rj.mu))
    np.testing.assert_allclose(res.opt_constr.numpy(), np.asarray(rj.opt_constr), rtol=1e-5, atol=1e-9)
    qn = torch.linalg.vector_norm(res.xs[:, :, 3:7], dim=-1)
    assert float((qn - 1).abs().max()) < 1e-10


def test_quadrotor_f32_row_is_finite_with_unit_quaternions():
    """The row in float32 (the card's type): finite controls and every
    terminal quaternion within 1e-5 of unit norm (test_model_zoo.py's f32
    bar), on both backward routes."""
    jm = jquadrotor(dtype=jnp.float64)
    dyn = jdyn.euler(jm, 0.02)
    q_goal = jm.integrate(jm.neutral_configuration(), jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2]))
    con = jcons.advance_time(
        jcons.StateTarget(model=jm, target=jbase.state_pack(q_goal, jnp.zeros(6)), active_ts=(H,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, jnp.float64), constraint=con,
                  horizon=H, second_order=False)  # fmt: skip
    tp = problem_from_numpy(spec_of(jp), device="cpu", dtype=torch.float32)
    x0s, us0 = quadrotor_inputs(jm, np.float32)
    for backward in ("sweep", "kernel"):
        res = solve_batched(tp, SolverParams(**RECIPE), t(x0s), us_init=t(us0), backward=backward, **RECIPE_KW)
        assert bool(torch.isfinite(res.us).all()) and res.us.dtype == torch.float32
        qn = torch.linalg.vector_norm(res.xs[:, -1, 3:7].double(), dim=-1)
        np.testing.assert_allclose(qn.numpy(), 1.0, atol=1e-5)


# ---------------------------------------------- tests/test_batched_solver.py


def test_batched_cholesky_failure_recovery():
    """≙ test_batched_solver.py::test_batched_cholesky_failure_recovery:
    lanes whose first factorizations fail at μ = 1e8 still reach the target
    (per-lane reg escalation), as in ddp_tpu."""
    jp = jax_pendulum_problem(100, jnp.float64, second_order=True)
    tp = torch_problem(jp)
    x0s = np.array([[q, 0.0] for q in (-0.3, 0.0, 0.2, 0.5)])
    kw = dict(max_iterations=50, threshold=1e-9, mu=1e8)
    res = solve_batched(tp, SolverParams(**kw), t(x0s))
    assert bool(torch.isfinite(res.us).all())
    np.testing.assert_allclose(res.xs[:, -1, 0].numpy(), 3.14, atol=1e-5)
    assert float(res.opt_constr.max()) < 1e-6
    rj = jax.jit(lambda x: jsolve_batched(jp, JParams(**kw), x))(x0s)
    np.testing.assert_allclose(res.xs[:, -1, 0].numpy(), np.asarray(rj.xs[:, -1, 0]), atol=1e-6)


def test_batched_float32():
    """≙ test_batched_solver.py::test_batched_float32: f32 solves to an
    f32-appropriate tolerance."""
    jp = jax_pendulum_problem(100, jnp.float32, second_order=True)
    tp = torch_problem(jp, np.float32)
    res = solve_batched(tp, SolverParams(max_iterations=30, threshold=1e-5, mu=1e4), torch.zeros(4, 2))
    assert bool(torch.isfinite(res.us).all())
    np.testing.assert_allclose(res.xs[:, -1, 0].numpy(), 3.14, atol=5e-2)
