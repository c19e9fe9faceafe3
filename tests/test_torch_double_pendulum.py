"""BASELINE configs[2], the double-pendulum reach of
benchmarks/double_pendulum_reach.py, in the port against ddp_tpu on the CPU,
f64: the recipe built from the port's own constructors and solved through
the kernel route (``deriv="kernel"``, ``backward="kernel"``: on CPU tensors
the wrappers take their plain versions) against ddp_tpu's jitted
``deriv="jvp"``/``backward="sweep"`` solve, and kernel #1's plain version at
the recipe's (n, m, e) = (4, 2, 2) Gauss-Newton against ddp_tpu's Pallas
sweep in interpret mode.

Bars: us within 1e-8 of each lane's largest |u| (at least 1), μ identical
(the chains' bar in tests/test_torch_second_order.py); the Riccati gains at
tests/test_pallas_riccati.py's tolerances (1e-9 in f64, 2e-4/2e-5 in f32)
and ok equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (
    jax_config_problem,
    random_spd_derivs,
    t,
    to_jax_derivs,
    to_torch_derivs,
    torch_problem,
)

from ddp_tpu.kernels.riccati_small import backward_sweep_pallas
from ddp_tpu.kernels.riccati_small import pack_batch_last as jax_pack
from ddp_tpu.models.rigid_body import double_pendulum as jdouble_pendulum
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.models.rigid_body import double_pendulum
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.solve import SolverParams

jax.config.update("jax_enable_x64", True)

# the recipe at B = 4, H = 8, 3 of its 12 iterations
B, H = 4, 8
TARGET = (0.8, -0.5)
PARAMS = dict(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
KW = dict(matmul_precision="high", n_linesearch=8, forward="seq")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_recipe(horizon, dtype=torch.float64):
    """benchmarks/double_pendulum_reach.py's problem from the port's
    constructors: Euler (dt = 0.01) double pendulum, ½‖u‖², q = (0.8, −0.5)
    at the horizon, advanced twice, Gauss-Newton."""
    kw = dict(device="cpu", dtype=dtype)
    model = double_pendulum(**kw)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(model, torch.tensor(TARGET, **kw), (horizon,)), dyn, times=2
    )
    return Problem(dyn, costs.quad_control(1.0, **kw), con, horizon, second_order=False)


def recipe_x0s(n):
    """The recipe's draw from default_rng(0): q ~ U(−0.3, 0.3), v ~ 0.2·N(0, 1)."""
    rng = np.random.default_rng(0)
    q, v = rng.uniform(-0.3, 0.3, (n, 2)), 0.2 * rng.standard_normal((n, 2))
    return np.concatenate([q, v], axis=1)


@pytest.fixture(scope="module")
def solves(monkeypatch_module):
    """ddp_tpu's jitted jvp/sweep solve and the port's kernel-route solve of
    the recipe, with the calls of the two kernels' plain versions counted
    (each stands where the card launches its kernel once)."""
    jp = jax_config_problem(jdouble_pendulum(dtype=jnp.float64), list(TARGET), H)
    x0s = recipe_x0s(B)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(
            jp, JParams(**PARAMS), x, deriv="jvp", backward="sweep", **KW
        )
    )(jnp.asarray(x0s))
    calls = {"fd": 0, "riccati": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch_module.setattr(fd, "fd_derivs_reference", counted("fd", fd.fd_derivs_reference))
    monkeypatch_module.setattr(
        rs, "backward_ladder_reference", counted("riccati", rs.backward_ladder_reference)
    )
    before = (fd.LAUNCHES, rs.LAUNCHES)
    tr = solve_batched(port_recipe(H), SolverParams(**PARAMS), t(x0s), deriv="kernel",
                       backward="kernel", **KW)  # fmt: skip
    assert (fd.LAUNCHES, rs.LAUNCHES) == before  # CPU tensors: no kernel
    return jr, tr, dict(calls)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_recipe_kernel_route_matches_ddp_tpu(solves):
    jr, tr, _ = solves
    ref = np.asarray(jr.us)
    scale = np.maximum(1.0, np.abs(ref).max(axis=(1, 2), keepdims=True))
    assert tr.us.shape == (B, H, 2) and bool(torch.isfinite(tr.us).all())
    assert float((np.abs(tr.us.numpy() - ref) / scale).max()) <= 1e-8
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    np.testing.assert_allclose(
        tr.opt_constr.numpy(), np.asarray(jr.opt_constr), rtol=1e-8, atol=1e-12
    )


def test_recipe_reaches_each_kernel_as_the_card_counts_launches(solves):
    """A derivative pass before the loop, one an iteration and one for the
    final optimality (#2); a backward call before the loop and one an
    iteration, each the whole ladder (#1): chip_smoke.py's exact counts at
    12 iterations are 14 and 13."""
    _, _, calls = solves
    assert calls == {"fd": 2 + PARAMS["max_iterations"], "riccati": 1 + PARAMS["max_iterations"]}


def test_recipe_is_benchmarks_recipe():
    """The problem built from the port's constructors is ddp_tpu's recipe
    carried over leaf by leaf (``torch_problem``): the same rollout and
    derivatives bit for bit on a seeded input, at the (n, m, e) = (4, 2, 2)
    of #1's library for the recipe."""
    tp = port_recipe(H)
    cp = torch_problem(jax_config_problem(jdouble_pendulum(dtype=jnp.float64), list(TARGET), H))
    assert (tp.ndx, tp.nu, tp.ne) == (4, 2, 2) == (cp.ndx, cp.nu, cp.ne)
    rng = np.random.default_rng(1)
    x0s, us = t(recipe_x0s(B)), t(0.3 * rng.standard_normal((B, H, 2)))
    xs = tp.rollout(x0s, us)
    assert torch.equal(xs, cp.rollout(x0s, us))
    for a, b in zip(tp.derivatives(xs, us), cp.derivatives(xs, us)):
        assert torch.equal(a, b)
    assert rs.instantiation(tp.ndx, tp.nu, tp.ne) == {"N": 4, "M": 2, "E": 2, "SO": 0}


@pytest.mark.parametrize(
    "np_dtype,rtol,atol", [(np.float64, 1e-9, 1e-9), (np.float32, 2e-4, 2e-5)], ids=["f64", "f32"]
)
def test_riccati_plain_version_at_n4m2e2_matches_pallas(np_dtype, rtol, atol):
    """#1's plain version at the recipe's Gauss-Newton (4, 2, 2) against
    ddp_tpu's Pallas sweep in interpret mode on numpy-seeded SPD blocks,
    one reg level, through the wrapper (which takes the plain version on the
    CPU)."""
    Bk, T, (n, m, e) = 6, 5, (4, 2, 2)
    fields, pe, pex = random_spd_derivs(Bk, T, n, m, e, seed=21, np_dtype=np_dtype)
    mu, reg = np.full(Bk, 1e3, np_dtype), np.full(Bk, 1e-6, np_dtype)
    packed = jax_pack(to_jax_derivs(fields), jnp.asarray(pe), jnp.asarray(pex))
    k_p, K_p, ok_p = backward_sweep_pallas(
        packed, jnp.asarray(mu), jnp.asarray(reg), T=T, n=n, m=m, e=e, block_b=Bk, interpret=True
    )
    k, K, ok, reg_used = rs.backward_ladder(
        to_torch_derivs(fields), t(pe), t(pex), t(mu), t(reg[None])
    )
    assert bool(ok.all()) and ok.tolist() == np.asarray(ok_p).tolist()
    assert torch.equal(reg_used, t(reg))
    k_ref = np.transpose(np.asarray(k_p), (2, 0, 1))
    np.testing.assert_allclose(k.numpy(), k_ref, rtol=rtol, atol=atol)
    K_ref = np.transpose(np.asarray(K_p).reshape(T, m, n, Bk), (3, 0, 1, 2))
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=rtol, atol=atol)

