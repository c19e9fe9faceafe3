"""UR5 through the port, f64 on the CPU, against ddp_tpu on the same
numpy-seeded inputs: the fd-derivatives modules' plain versions at nv = 6
(≙ the ``ur5`` case of tests/test_fd_derivs_kernel.py, and
tests/test_fd_derivs2_kernel.py's oracle), tests/test_arm_ddp.py's two UR5
``solve`` anchors, and the Gauss-Newton → full-DDP chain of
benchmarks/arm_second_order.py at B = 4, H = 5."""

import functools

import numpy as np
import pytest
import torch
from torch_parity_helpers import jax_warm_start, t, torch_problem, warm_state_of

import jax
import jax.numpy as jnp

from ddp_tpu.models import base as jbase
from ddp_tpu.models.robots import ur5 as jur5
from ddp_tpu.ocp import constraints as jcons
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdyn
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch import solve
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import fd_derivs2 as fd2
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.base import state_pack
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
OUTPUTS = ("a", "da_dq", "da_dv", "Minv", "H")
BARS = (1e-9, 1e-9, 1e-9, 1e-9, 1e-8)


@functools.lru_cache(maxsize=None)
def arms():
    return jur5(dtype=jnp.float64), robots.ur5(**F64)


def inputs(N, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N, 6)) for _ in range(3))


def close_scaled(got, ref, tol, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=what)


# ----------------------------------------------------- fd modules at nv = 6


@functools.lru_cache(maxsize=None)
def fd_case():
    """128 samples (tests/test_fd_derivs_kernel.py's N): ddp_tpu's implicit
    rule under vmap and the port's plain version of kernel #2."""
    jm, tm = arms()
    q, v, tau = inputs(128)
    ref = jax.jit(jax.vmap(jm.fd_derivatives))(q, v, tau)
    return tm, (q, v, tau), ref, fd.fd_derivs_reference(tm, t(q), t(v), t(tau))


@pytest.mark.parametrize("k", range(4), ids=OUTPUTS[:4])
def test_fd_reference_matches_ddp_tpu_on_ur5(k):
    *_, ref, got = fd_case()
    assert tuple(got[k].shape) == ref[k].shape
    close_scaled(got[k], ref[k], BARS[k])


@functools.lru_cache(maxsize=None)
def fd2_case():
    """ddp_tpu's jacfwd∘jacfwd oracle of its forward dynamics
    (tests/test_fd_derivs2_kernel.py::_hessian_oracle) and the port's plain
    version of kernel #3, on 4 samples."""
    jm, tm = arms()
    q, v, tau = inputs(4, seed=1)
    nv = 6

    def a_fn(z):
        return jm.forward_dynamics(z[:nv], z[nv : 2 * nv], z[2 * nv :])

    z = jnp.concatenate([jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau)], axis=1)
    J = jax.jit(jax.vmap(jax.jacfwd(a_fn)))(z)
    ref = (jax.vmap(a_fn)(z), J[..., :nv], J[..., nv : 2 * nv], J[..., 2 * nv :],
           jax.jit(jax.vmap(jax.jacfwd(jax.jacfwd(a_fn))))(z))  # fmt: skip
    return tm, (q, v, tau), ref, fd2.fd_derivs2_reference(tm, t(q), t(v), t(tau))


@pytest.mark.parametrize("k", range(5), ids=OUTPUTS)
def test_fd2_reference_matches_ddp_tpu_hessian_on_ur5(k):
    *_, ref, got = fd2_case()
    assert tuple(got[k].shape) == ref[k].shape
    close_scaled(got[k], ref[k], BARS[k])
    if k == 4:
        H = got[4]
        np.testing.assert_array_equal(H.numpy(), H.transpose(-1, -2).numpy())
        assert float(H[:, :, 12:, 12:].abs().max()) == 0.0


def test_wrappers_on_cpu_are_the_plain_versions_on_ur5():
    tm, (q, v, tau), _, got = fd_case()
    before = (fd.LAUNCHES, fd2.LAUNCHES)
    out = fd.fd_derivs(tm, t(q), t(v), t(tau))
    out2 = fd2.fd_derivs2(tm, t(q[:4]), t(v[:4]), t(tau[:4]))
    assert (fd.LAUNCHES, fd2.LAUNCHES) == before  # no kernel for CPU tensors
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    ref2 = fd2.fd_derivs2_reference(tm, t(q[:4]), t(v[:4]), t(tau[:4]))
    assert all(torch.equal(a, b) for a, b in zip(out2, ref2))
    assert fd.check_model(tm) == 6 and fd.instantiation(6) == {"NV": 6}


# ----------------------------------------------------------- solve anchors


def config_problem(model, H, delta, second_order, dtype=torch.float64):
    """tests/test_arm_ddp.py's UR5 problem in the port: Euler dt = 0.01,
    ½‖u‖², the configuration q0 ⊕ delta at H, advanced twice."""
    kw = dict(device=model.device, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    q0 = model.neutral_configuration()
    target = model.integrate(q0, torch.as_tensor(delta, **kw))
    con = constraints.advance_time(constraints.ConfigTarget(model, target, (H,)), dyn, times=2)
    problem = Problem(dyn, costs.quad_control(1.0, **kw), con, H, second_order=second_order)
    return problem, target, state_pack(q0, torch.zeros(model.nv, **kw))


def test_ur5_config_constrained_ddp():
    """≙ test_arm_ddp.py::test_ur5_config_constrained_ddp through the port's
    ``solve``: H = 10, Gauss-Newton, 45 iterations."""
    arm = robots.ur5(**F64)
    problem, target, x0 = config_problem(arm, 10, 0.05 * np.arange(1.0, 7.0), False)
    res = solve(problem, SolverParams(max_iterations=45, threshold=1e-8, mu=1e8), x0)
    assert float(res.stats.opt_constr) < 1e-5
    err = arm.difference(target, res.xs[-1, : arm.nq])
    assert float(err.abs().max()) < 1e-4, err


def test_ur5_full_ddp_second_order():
    """≙ test_arm_ddp.py::test_ur5_full_ddp_second_order through the port's
    ``solve``: H = 5, full DDP, 25 iterations."""
    arm = robots.ur5(**F64)
    problem, _, x0 = config_problem(arm, 5, 0.02 * np.ones(6), True)
    res = solve(problem, SolverParams(max_iterations=25, threshold=1e-8, mu=1e8), x0)
    assert float(res.stats.opt_constr) < 1e-6


# ------------------------------------------------ GN → full-DDP chain, B = 4

CHAIN_B, CHAIN_H = 4, 5
GN = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
DDP = dict(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)
# benchmarks/arm_second_order.py's knobs
CHAIN_KW = dict(n_linesearch=4, forward="seq")


def jax_chain_problem(second_order):
    """benchmarks/arm_second_order.py's problem at H = 5: the configuration
    q0 ⊕ 0.05·(1 … 6) at H, advanced twice."""
    arm = arms()[0]
    dyn = jdyn.euler(arm, 0.01)
    q0 = arm.neutral_configuration()
    q_target = arm.integrate(q0, jnp.asarray(0.05 * np.arange(1.0, 7.0)))
    con = jcons.advance_time(
        jcons.ConfigTarget(model=arm, target=q_target, active_ts=(CHAIN_H,)), dyn, times=2
    )
    return JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64),
                    constraint=con, horizon=CHAIN_H, second_order=second_order)  # fmt: skip


@functools.lru_cache(maxsize=None)
def chain_runs():
    """The chain in both packages from x0 = neutral at rest + 0.1·N(0, 1)
    (default_rng(0)): ddp_tpu through jvp/sweep, the port through the fd and
    Riccati kernels' plain versions (deriv="kernel", backward="kernel")."""
    jg, jd = jax_chain_problem(False), jax_chain_problem(True)
    arm = arms()[0]
    x0 = jbase.state_pack(arm.neutral_configuration(), jnp.zeros(6))
    x0s = np.asarray(x0)[None] + 0.1 * np.random.default_rng(0).standard_normal((CHAIN_B, 12))
    r1 = jax.jit(lambda x: jbatched.solve_batched(jg, JParams(**GN), x, **CHAIN_KW))(
        jnp.asarray(x0s)
    )
    jr = jax.jit(lambda x, kw: jbatched.solve_batched(jd, JParams(**DDP), x, **CHAIN_KW, **kw))(
        jnp.asarray(x0s), jax_warm_start(warm_state_of(r1))
    )
    tg, td = torch_problem(jg), torch_problem(jd)
    kw = dict(deriv="kernel", backward="kernel", matmul_precision="high", **CHAIN_KW)
    t1 = tbatched.solve_batched(tg, SolverParams(**GN), t(x0s), **kw)
    tr = tbatched.solve_batched(
        td, SolverParams(**DDP), t(x0s), us_init=t1.us, mults_init=t1.mults, mu_init=t1.mu,
        reg_init=t1.reg, w_init=t1.w, n_init=t1.n, **kw,
    )  # fmt: skip
    return td, (r1, jr), (t1, tr)


def lane_scaled_err(got, ref):
    ref = np.asarray(ref)
    scale = np.maximum(1.0, np.abs(ref).max(axis=(1, 2)))
    return float((np.abs(got.numpy() - ref).max(axis=(1, 2)) / scale).max())


@pytest.mark.slow  # ddp_tpu's compile of the 6-DoF full-DDP solve takes over a minute
def test_ur5_chain_matches_ddp_tpu():
    """Both stages: us within 1e-7 of each lane's largest |u| and identical
    μ, the polish moving the Gauss-Newton controls and keeping every lane
    as feasible as it was."""
    td, (r1, jr), (t1, tr) = chain_runs()
    for got, ref in ((t1, r1), (tr, jr)):
        assert lane_scaled_err(got.us, ref.us) <= 1e-7
        np.testing.assert_array_equal(got.mu.numpy(), np.asarray(ref.mu))
    assert float((tr.us - t1.us).abs().max()) > 1e-9
    assert bool((tr.opt_constr <= t1.opt_constr + 1e-6).all())
    assert td.second_order and rs.instantiation(12, 6, 6, True) == {"N": 12, "M": 6, "E": 6, "SO": 1}


def test_ur5_chain_routes_agree():
    """The same chain within the port through the kernels' plain versions
    (deriv="kernel", backward="kernel") and through jvp/sweep: us within
    1e-7 of each lane's largest |u| and identical μ after each stage (the
    route bar chip_smoke.py holds the card's kernels to)."""
    jg, jd = jax_chain_problem(False), jax_chain_problem(True)
    tg, td = torch_problem(jg), torch_problem(jd)
    x0 = state_pack(robots.ur5(**F64).neutral_configuration(), torch.zeros(6, **F64))
    x0s = x0[None] + 0.1 * t(np.random.default_rng(0).standard_normal((CHAIN_B, 12)))
    out = {}
    for route in (("kernel", "kernel"), ("jvp", "sweep")):
        kw = dict(deriv=route[0], backward=route[1], **CHAIN_KW)
        r1 = tbatched.solve_batched(tg, SolverParams(**GN), x0s, **kw)
        r2 = tbatched.solve_batched(
            td, SolverParams(**DDP), x0s, us_init=r1.us, mults_init=r1.mults, mu_init=r1.mu,
            reg_init=r1.reg, w_init=r1.w, n_init=r1.n, **kw,
        )  # fmt: skip
        out[route] = (r1, r2)
    for a, b in zip(*out.values()):
        assert lane_scaled_err(a.us, b.us.numpy()) <= 1e-7
        assert torch.equal(a.mu, b.mu)
