"""ddp_tpu_torch's full second-order DDP slice against ddp_tpu on the same
numpy-seeded inputs, f64 on the CPU: ``Problem.derivatives`` with the
dynamics and constraint Hessians, the ``f_hess`` injection, ``solve_batched``
on a ``second_order`` problem through every derivative and backward backend
(on CPU tensors the kernels' wrappers take their plain versions), and the
warm-started Gauss-Newton → full-DDP chain."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (
    PANDA_READY,
    arm_inputs,
    headline_x0s,
    jax_arm_problem,
    jax_config_problem,
    jax_pendulum_problem,
    jax_warm_start,
    t,
    torch_problem,
    warm_state_of,
)

from ddp_tpu.models import robots as jrobots
from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import warm_start_from_numpy
from ddp_tpu_torch.kernels import fd_derivs2 as fd2
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

jax.config.update("jax_enable_x64", True)

ACROBOT_READY = (0.3, -0.5)
SLOW_PANDA = pytest.param("panda7", marks=pytest.mark.slow)  # the JAX compile takes minutes


def jax_problem(name, horizon, second_order=True):
    if name == "pendulum":
        return jax_pendulum_problem(horizon, jnp.float64, second_order=second_order)
    if name == "cartpole":
        model = jrobots.cartpole(dtype=jnp.float64)
        return jax_config_problem(model, [0.1, 0.2], horizon, second_order)
    make, frame, ready = {
        "acrobot": (jrobots.acrobot, "tip", ACROBOT_READY),
        "panda7": (jrobots.panda7, "ee", PANDA_READY),
    }[name]
    return jax_arm_problem(make(dtype=jnp.float64), frame, ready, horizon, second_order)


def close_scaled(got, ref, tol, err_msg=""):
    """|got − ref| ≤ tol · max(1, max|ref|): "tol relative" to the array."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=err_msg)


# ------------------------------------------------------------- derivatives


@functools.lru_cache(maxsize=None)
def deriv_case(name):
    """Both packages' second-order problems and their derivatives along one
    numpy-seeded trajectory; for a robot also the port's derivatives with the
    dynamics blocks from the second-order fd-derivatives module."""
    B, H = 2, 4
    jp = jax_problem(name, H)
    tp = torch_problem(jp)
    rng = np.random.default_rng(31)
    x0s = 0.3 * rng.normal(size=(B, jp.nx))
    us = 0.3 * rng.normal(size=(B, H, jp.nu))
    xs = np.asarray(jax.vmap(jp.rollout)(jnp.asarray(x0s), jnp.asarray(us)))
    jd = jax.jit(jax.vmap(jp.derivatives))(jnp.asarray(xs), jnp.asarray(us))
    td = tp.derivatives(t(xs), t(us))
    tdk = None
    if name != "pendulum":
        tdk = tbatched._kernel_derivatives(tp)(t(xs), t(us))
    return jp, tp, xs, us, jd, td, tdk


@pytest.mark.parametrize("field", JDerivs._fields)
@pytest.mark.parametrize("name", ["pendulum", "cartpole", "acrobot", SLOW_PANDA])
def test_second_order_derivs_field(name, field):
    """All 18 Derivs fields, 1e-9 relative to each array's largest entry."""
    *_, jd, td, _ = deriv_case(name)
    ref, got = np.asarray(getattr(jd, field)), getattr(td, field)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float64
    close_scaled(got, ref, 1e-9, field)


@pytest.mark.parametrize("field", JDerivs._fields)
@pytest.mark.parametrize("name", ["cartpole", "acrobot", SLOW_PANDA])
def test_second_order_derivs_field_with_kernel_blocks(name, field):
    """… and with fx, fu and the dynamics Hessian assembled from the
    second-order fd-derivatives module, as deriv="kernel" hands them to
    ``Problem.derivatives(fx_fu=…, f_hess=…)``."""
    *_, jd, _, tdk = deriv_case(name)
    ref, got = np.asarray(getattr(jd, field)), getattr(tdk, field)
    assert tuple(got.shape) == ref.shape
    close_scaled(got, ref, 1e-9, field)


@pytest.mark.parametrize("name", ["pendulum", "cartpole", "acrobot"])
def test_hessians_are_not_trivial(name):
    _, tp, *_, td, _ = deriv_case(name)
    assert tp.second_order
    assert float(td.fxx.abs().max()) > 0 and float(td.eqxx.abs().max()) > 0
    active = torch.zeros(tp.horizon, dtype=torch.bool)
    active[list(tp.active_ts())] = True
    assert bool((td.eqxx[:, ~active] == 0).all())  # the m2 mask
    if name != "pendulum":
        assert float(td.fux.abs().max()) > 0
    # symmetric in the two differentiation slots
    np.testing.assert_allclose(td.fxx.numpy(), td.fxx.transpose(-1, -2).numpy(), atol=1e-12)


def test_f_hess_is_used_as_given():
    _, tp, xs, us, _, td, _ = deriv_case("acrobot")
    B, T = us.shape[:2]
    ndx, nu = tp.ndx, tp.nu
    nz = ndx + nu
    rng = np.random.default_rng(32)
    fx, fu = t(rng.normal(size=(B, T, ndx, ndx))), t(rng.normal(size=(B, T, ndx, nu)))
    fzz = t(rng.normal(size=(B, T, ndx, nz, nz)))
    d = tp.derivatives(t(xs), t(us), fx_fu=(fx, fu), f_hess=fzz)
    assert torch.equal(d.fx, fx) and torch.equal(d.fu, fu)
    assert torch.equal(d.fxx, fzz[..., :ndx, :ndx])
    assert torch.equal(d.fux, fzz[..., ndx:, :ndx])
    assert torch.equal(d.fuu, fzz[..., ndx:, ndx:])
    # cost and constraint derivatives do not depend on the injected blocks
    for f in ("lxx", "luu", "eq", "eqx", "eqxx", "equx", "equu", "lfxx"):
        assert torch.equal(getattr(d, f), getattr(td, f)), f


def test_derivatives_argument_checks():
    """The three argument checks of ddp_tpu's ``Problem.derivatives``, with
    its messages."""
    _, tp, xs, us, *_ = deriv_case("acrobot")
    B, T = us.shape[:2]
    fx = torch.zeros(B, T, tp.ndx, tp.ndx, dtype=torch.float64)
    fu = torch.zeros(B, T, tp.ndx, tp.nu, dtype=torch.float64)
    fzz = torch.zeros(B, T, tp.ndx, tp.ndx + tp.nu, tp.ndx + tp.nu, dtype=torch.float64)
    with pytest.raises(ValueError, match="without f_hess is first-order"):
        tp.derivatives(t(xs), t(us), fx_fu=(fx, fu))
    with pytest.raises(ValueError, match="f_hess requires matching fx_fu"):
        tp.derivatives(t(xs), t(us), f_hess=fzz)

    class NoJacobians(torch.nn.Module):
        analytic_jacobians_ok = False
        model = tp.model

    import copy

    broken = copy.copy(tp)
    broken._modules = dict(tp._modules, dynamics=NoJacobians())
    with pytest.raises(ValueError, match="fx_fu requires dynamics.analytic_jacobians_ok"):
        broken.derivatives(t(xs), t(us), fx_fu=(fx, fu), f_hess=fzz)
    # the first two raise the same in ddp_tpu
    jp = deriv_case("acrobot")[0]
    with pytest.raises(ValueError, match="without f_hess is first-order"):
        jp.derivatives(jnp.asarray(xs[0]), jnp.asarray(us[0]), fx_fu=(fx[0].numpy(), fu[0].numpy()))
    with pytest.raises(ValueError, match="f_hess requires matching fx_fu"):
        jp.derivatives(jnp.asarray(xs[0]), jnp.asarray(us[0]), f_hess=fzz[0].numpy())


# -------------------------------------------- whole slice: cold full DDP


# ≙ test_fd_derivs2_kernel.py::test_solve_batched_full_ddp_deriv_pallas_matches_jvp:
# cartpole, B = 16, H = 8, 3 full-DDP iterations; ddp_tpu through deriv="jvp",
# the port through every derivative × backward backend
CARTPOLE = dict(max_iterations=3, threshold=1e-9, mu=1e4)
CARTPOLE_X0S = 0.3 * np.random.default_rng(1).standard_normal((16, 4))


@functools.lru_cache(maxsize=None)
def cartpole_jax():
    jp = jax_problem("cartpole", 8)
    return jax.jit(lambda x: jbatched.solve_batched(jp, JParams(**CARTPOLE), x, deriv="jvp"))(
        jnp.asarray(CARTPOLE_X0S)
    )


@functools.lru_cache(maxsize=None)
def cartpole_port(deriv, backward, second_order=True):
    tp = torch_problem(jax_problem("cartpole", 8, second_order))
    before = (fd2.LAUNCHES, rs.LAUNCHES)
    res = tbatched.solve_batched(
        tp, SolverParams(**CARTPOLE), t(CARTPOLE_X0S), deriv=deriv, backward=backward
    )
    assert (fd2.LAUNCHES, rs.LAUNCHES) == before  # CPU tensors: the plain versions ran
    return res


COMBOS = [("jvp", "sweep"), ("jvp", "kernel"), ("kernel", "sweep"), ("kernel", "kernel")]


@pytest.mark.parametrize("deriv,backward", COMBOS)
def test_full_ddp_solve_matches_jax(deriv, backward):
    """us, opt_constr 1e-9 (the JAX test's bars), identical μ."""
    jr, tr = cartpole_jax(), cartpole_port(deriv, backward)
    np.testing.assert_allclose(tr.us.numpy(), np.asarray(jr.us), atol=1e-9)
    np.testing.assert_allclose(tr.opt_constr.numpy(), np.asarray(jr.opt_constr), atol=1e-9)
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    close_scaled(tr.xs, jr.xs, 1e-9)


def test_full_ddp_deriv_kernel_matches_jvp():
    """Within the port: the second-order fd-derivatives path equals the
    jacfwd-over-assembled-Jacobian path."""
    a, b = cartpole_port("kernel", "kernel"), cartpole_port("jvp", "sweep")
    np.testing.assert_allclose(a.us.numpy(), b.us.numpy(), atol=1e-9)
    np.testing.assert_allclose(a.opt_constr.numpy(), b.opt_constr.numpy(), atol=1e-9)
    assert torch.equal(a.mu, b.mu)


def test_full_ddp_differs_from_gauss_newton():
    """The Hessians change the iterates: the same budget in Gauss-Newton
    mode ends elsewhere (so the tests above are not comparing GN with GN)."""
    gn = cartpole_port("jvp", "sweep", second_order=False)
    assert float((gn.us - cartpole_port("jvp", "sweep").us).abs().max()) > 1e-6


@functools.lru_cache(maxsize=None)
def pendulum_solves():
    """The headline schedule in full-DDP mode at B = 8, H = 32: ddp_tpu's
    Pallas backward in interpret mode with the rank-3 terms, the port's
    kernel backend (its plain version on the CPU)."""
    B, H = 8, 32
    jp = jax_problem("pendulum", H)
    tp = torch_problem(jp)
    params = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    kw = dict(n_reg_levels=4, n_linesearch=4)
    x0s = headline_x0s(B, np.float64)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(
            jp, JParams(**params), x, backward="pallas", interpret=True, **kw
        )
    )(x0s)
    tr = tbatched.solve_batched(tp, SolverParams(**params), t(x0s), backward="kernel", **kw)
    return jr, tr


@pytest.mark.parametrize("field", ["xs", "us", "fb_k", "fb_K"])
def test_pendulum_full_ddp_matches_pallas(field):
    jr, tr = pendulum_solves()
    close_scaled(getattr(tr, field), getattr(jr, field), 1e-9, field)


def test_pendulum_full_ddp_schedule_state_matches_pallas():
    jr, tr = pendulum_solves()
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    for name in ("reg", "w", "n"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), atol=0.0, rtol=1e-12,
            err_msg=name,
        )  # fmt: skip
    np.testing.assert_allclose(tr.opt_constr.numpy(), np.asarray(jr.opt_constr), atol=1e-12)
    for name in ("val", "jac"):
        close_scaled(getattr(tr.mults, name), getattr(jr.mults, name), 1e-9, name)
    assert bool((tr.opt_constr < 1e-2).all())


# ----------------------------------------- warm-started GN → full-DDP chain

GN = dict(max_iterations=6, threshold=1e-5, mu=1e4, inner_iters_max=1)
DDP = dict(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)
# the polish stage's backends (benchmarks/arm_second_order.py's recipe)
CHAIN_KW = dict(n_linesearch=4, forward="seq")


@functools.lru_cache(maxsize=None)
def chain(name):
    """A Gauss-Newton solve in ddp_tpu, then four full-DDP iterations
    warm-started on its (us, mults, μ, reg, w, n) in BOTH packages, the
    state handed across as numpy."""
    B, H = 4, 8
    jg, jd = jax_problem(name, H, second_order=False), jax_problem(name, H)
    ready = ACROBOT_READY if name == "acrobot" else PANDA_READY
    x0s, us0 = arm_inputs(jg.model, ready, B, H)
    r1 = jax.jit(
        lambda x, u: jbatched.solve_batched(
            jg, JParams(**GN), x, us_init=u, deriv="jvp", forward="seq", n_linesearch=2
        )
    )(jnp.asarray(x0s), jnp.asarray(us0))
    state = warm_state_of(r1)
    jr = jax.jit(
        lambda x, kw: jbatched.solve_batched(jd, JParams(**DDP), x, deriv="jvp", **CHAIN_KW, **kw)
    )(jnp.asarray(x0s), jax_warm_start(state))
    tp = torch_problem(jd)
    tr = tbatched.solve_batched(
        tp, SolverParams(**DDP), t(x0s), deriv="kernel", backward="kernel",
        matmul_precision="highest", **CHAIN_KW,
        **warm_start_from_numpy(state, device="cpu", dtype=torch.float64),
    )  # fmt: skip
    return jg, tp, x0s, us0, r1, state, jr, tr


def check_chain(name):
    *_, r1, state, jr, tr = chain(name)
    for f in ("us", "xs"):
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        scale = np.maximum(1.0, np.abs(ref).max(axis=(1, 2), keepdims=True))
        assert float((np.abs(got - ref) / scale).max()) <= 1e-8, f
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    np.testing.assert_array_equal(tr.reg.numpy(), np.asarray(jr.reg))
    for f in ("w", "n"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), rtol=1e-12)
    np.testing.assert_allclose(tr.opt_constr.numpy(), np.asarray(jr.opt_constr), rtol=1e-8, atol=1e-12)
    close_scaled(tr.opt_lag, jr.opt_lag, 1e-8)
    close_scaled(tr.mults.val, jr.mults.val, 1e-8)
    close_scaled(tr.fb_K, jr.fb_K, 1e-8)
    # the polish moved the GN solution, and kept it feasible
    assert float(np.abs(np.asarray(jr.us) - state["us"]).max()) > 1e-9
    assert bool((tr.opt_constr <= torch.as_tensor(np.asarray(r1.opt_constr)) + 1e-6).all())


def test_warm_started_chain_matches_jax_acrobot():
    check_chain("acrobot")


@pytest.mark.slow  # the JAX side's compile of the 7-DoF full-DDP solve takes minutes
def test_warm_started_chain_matches_jax_panda7():
    check_chain("panda7")


def test_chain_within_the_port_matches_the_handed_over_chain():
    """The same chain run wholly in the port (GN solve, then full DDP from
    its own result) lands on the chain warm-started from ddp_tpu's state:
    the two GN solves agree to ~1e-9, and four polish iterations keep that."""
    jg, tp, x0s, us0, _, _, _, tr = chain("acrobot")
    r1 = tbatched.solve_batched(
        torch_problem(jg), SolverParams(**GN), t(x0s), us_init=t(us0), deriv="kernel",
        backward="kernel", forward="seq", n_linesearch=2,
    )  # fmt: skip
    r2 = tbatched.solve_batched(
        tp, SolverParams(**DDP), t(x0s), us_init=r1.us, mults_init=r1.mults, mu_init=r1.mu,
        reg_init=r1.reg, w_init=r1.w, n_init=r1.n, deriv="kernel", backward="kernel", **CHAIN_KW,
    )  # fmt: skip
    close_scaled(r2.us, tr.us, 1e-7)
    assert torch.equal(r2.mu, tr.mu)


def test_warm_start_state_round_trips_through_numpy():
    *_, r1, state, _, _ = chain("acrobot")
    kw = warm_start_from_numpy(state, device="cpu", dtype=torch.float64)
    assert set(kw) == {"us_init", "mults_init", "mu_init", "reg_init", "w_init", "n_init"}
    for k in ("us", "mu", "reg", "w", "n"):
        np.testing.assert_array_equal(kw[f"{k}_init"].numpy(), np.asarray(getattr(r1, k)))
    for k in ("val", "jac", "origin"):
        np.testing.assert_array_equal(
            getattr(kw["mults_init"], k).numpy(), np.asarray(getattr(r1.mults, k))
        )
    jkw = jax_warm_start(warm_state_of(r1))
    np.testing.assert_array_equal(np.asarray(jkw["mults_init"].jac), np.asarray(r1.mults.jac))


def test_scalar_init_state_broadcasts_like_jax():
    """Scalar ``mu_init``/``reg_init``/``w_init``/``n_init`` broadcast to
    [B] as in ddp_tpu; the warm-start multipliers are re-anchored at the new
    rollout (origin ≠ the new trajectory here: other x0s)."""
    B, H = 4, 16
    jp = jax_pendulum_problem(H, jnp.float64, second_order=True)
    tp = torch_problem(jp)
    rng = np.random.default_rng(33)
    x0s = headline_x0s(B, np.float64)
    mults = dict(
        val=0.3 * rng.normal(size=(B, H, 1)),
        jac=0.1 * rng.normal(size=(B, H, 1, 2)),
        origin=0.2 * rng.normal(size=(B, H, 2)),
    )
    state = dict(us=0.1 * rng.normal(size=(B, H, 1)), mults=mults,
                 mu=np.full(B, 3e4), reg=np.full(B, 1e-3), w=np.full(B, 2e-3), n=np.full(B, 0.2))  # fmt: skip
    params = dict(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
    scal = dict(mu_init=3e4, reg_init=1e-3, w_init=2e-3, n_init=0.2)
    jkw = jax_warm_start(state)
    jr = jax.jit(
        lambda x, kw: jbatched.solve_batched(jp, JParams(**params), x, n_linesearch=4, **kw)
    )(x0s, dict(jkw, **scal))
    tkw = warm_start_from_numpy(state, device="cpu", dtype=torch.float64)
    full = tbatched.solve_batched(tp, SolverParams(**params), t(x0s), n_linesearch=4, **tkw)
    got = tbatched.solve_batched(
        tp, SolverParams(**params), t(x0s), n_linesearch=4, **dict(tkw, **scal)
    )
    for f in ("us", "mu", "reg", "w", "n"):
        assert torch.equal(getattr(got, f), getattr(full, f)), f
    close_scaled(got.us, jr.us, 1e-9)
    np.testing.assert_array_equal(got.mu.numpy(), np.asarray(jr.mu))
    close_scaled(got.mults.val, jr.mults.val, 1e-9)
    close_scaled(got.mults.jac, jr.mults.jac, 1e-9)
    cold = tbatched.solve_batched(tp, SolverParams(**params), t(x0s), n_linesearch=4)
    assert float((cold.us - got.us).abs().max()) > 1e-6  # the state was used


def test_constant_method_zeroes_the_warm_start_jacobian():
    """PRIMAL_DUAL_CONSTANT drops the multipliers' state-affine part of a
    warm start too (``constrain_jac``)."""
    from ddp_tpu_torch.solver.solve import Method

    *_, tp, x0s, _, _, state, _, _ = chain("acrobot")
    kw = warm_start_from_numpy(state, device="cpu", dtype=torch.float64)
    assert float(kw["mults_init"].jac.abs().max()) > 0
    r = tbatched.solve_batched(
        tp, SolverParams(**dict(DDP, max_iterations=1)), t(x0s),
        method=Method.PRIMAL_DUAL_CONSTANT, **CHAIN_KW, **kw,
    )  # fmt: skip
    assert bool((r.mults.jac == 0).all()) and bool(torch.isfinite(r.us).all())
