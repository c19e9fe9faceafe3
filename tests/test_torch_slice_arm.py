"""ddp_tpu_torch's arm slice against ddp_tpu on the same inputs, f64 on the
CPU: FrameTarget, Problem.derivatives with and without precomputed dynamics
Jacobians, the early-exit line search, matmul_precision, and the whole
batched fleet solve (bench.py's 7-DoF row at a small size) through
deriv="kernel", backward="kernel", forward="seq" — on CPU tensors both
kernels' wrappers take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import (
    PANDA_READY,
    arm_inputs,
    jax_arm_problem,
    jax_pendulum_problem,
    spec_of,
    t,
    torch_problem,
)

from ddp_tpu.models import robots as jrobots
from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.solver import al as jal
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

jax.config.update("jax_enable_x64", True)

B, H = 4, 8
# the fleet row's schedule (bench.py) at 3 iterations
ROW = dict(max_iterations=3, threshold=1e-5, mu=1e4, inner_iters_max=1)
ARMS = {
    "acrobot": (jrobots.acrobot, "tip", (0.3, -0.5)),
    "panda7": (jrobots.panda7, "ee", PANDA_READY),
}


def arm_case(name, horizon=H, batch=B):
    make, frame, ready = ARMS[name]
    jm = make(dtype=jnp.float64)
    jp = jax_arm_problem(jm, frame, ready, horizon)
    x0s, us0 = arm_inputs(jm, ready, batch, horizon)
    return jp, torch_problem(jp), x0s, us0


def close_scaled(got, ref, tol, err_msg=""):
    """|got − ref| ≤ tol · max(1, max|ref|) — "tol relative" to the array."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=err_msg)


# ------------------------------------------------------------- components


@pytest.fixture(scope="module")
def panda():
    """panda7 problems and one trajectory: the rollout of perturbed gravity
    compensation, plus the JAX package's derivatives along it."""
    jp, tp, x0s, us0 = arm_case("panda7", horizon=4, batch=2)
    us = us0 + 0.3 * np.random.default_rng(1).normal(size=us0.shape)
    xs = np.asarray(jax.vmap(jp.rollout)(jnp.asarray(x0s), jnp.asarray(us)))
    jd = jax.vmap(jp.derivatives)(jnp.asarray(xs), jnp.asarray(us))
    return jp, tp, x0s, us, xs, jd


def test_frame_target_value_and_rollout(panda):
    jp, tp, x0s, us, xs, _ = panda
    close_scaled(tp.rollout(t(x0s), t(us)), xs, 1e-10)
    assert tp.ne == jp.ne == 3 and tp.active_ts() == jp.active_ts()
    x, u = xs[:, 1], us[:, 1]
    ref = jax.vmap(lambda x_, u_: jp.constraint.value(2, x_, u_))(jnp.asarray(x), jnp.asarray(u))
    close_scaled(tp.constraint.value(2, t(x), t(u)), ref, 1e-10)
    inner_j, inner_t = jp.constraint.inner.inner, tp.constraint.inner.inner
    ref = jax.vmap(lambda x_, u_: inner_j.value(0, x_, u_))(jnp.asarray(x), jnp.asarray(u))
    close_scaled(inner_t.value(0, t(x), t(u)), ref, 1e-12)


@pytest.mark.parametrize("field", JDerivs._fields)
def test_derivatives_match_jax(panda, field):
    """Every Derivs field along the trajectory, 1e-9 relative."""
    _, tp, _, us, xs, jd = panda
    got = getattr(tp.derivatives(t(xs), t(us)), field)
    assert got.shape == getattr(jd, field).shape
    close_scaled(got, getattr(jd, field), 1e-9, field)


@pytest.mark.parametrize("field", JDerivs._fields)
def test_derivatives_with_fx_fu_match_jax(panda, field):
    """… and with the dynamics Jacobians precomputed by the fd-derivatives
    module, as deriv="kernel" assembles them."""
    _, tp, _, us, xs, jd = panda
    got = getattr(tbatched._kernel_derivatives(tp)(t(xs), t(us)), field)
    assert got.shape == getattr(jd, field).shape
    close_scaled(got, getattr(jd, field), 1e-9, field)


def test_fx_fu_is_used_as_given(panda):
    _, tp, _, us, xs, _ = panda
    Bn, T = us.shape[:2]
    fx = torch.full((Bn, T, tp.ndx, tp.ndx), 2.0, dtype=torch.float64)
    fu = torch.full((Bn, T, tp.ndx, tp.nu), 3.0, dtype=torch.float64)
    d = tp.derivatives(t(xs), t(us), fx_fu=(fx, fu))
    assert torch.equal(d.fx, fx) and torch.equal(d.fu, fu)


@pytest.mark.parametrize("scale", [1.0, 1e23, 1e25])
def test_optimality_lag_float32_past_the_square(panda, scale):
    """Multipliers past 1e19 (a lane whose μ raced) square past float32's
    range in ‖∂L/∂u_t‖ over the arm's seven controls.  The reported
    ``opt_lag`` stays finite and within float32 roundoff (rtol 1e-5) of
    ddp_tpu's float64 value, below that range (scale 1) and past it."""
    jp, tp, _, us, xs, jd = panda
    rng = np.random.default_rng(2)
    val = scale * rng.normal(size=(*us.shape[:2], 3))
    jac = 0.1 * rng.normal(size=(*us.shape[:2], 3, tp.ndx))
    ref = jax.vmap(lambda d, v, j: jal.optimality_lag(jp, d, v, j))(jd, val, jac)
    td32 = type(jd)(*(t(np.asarray(x, np.float32)) for x in jd))
    got = tal.optimality_lag(tp, td32, t(val.astype(np.float32)), t(jac.astype(np.float32)))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=0.0)


# ------------------------------------------------------------ line search


@pytest.fixture(scope="module")
def acrobot():
    return arm_case("acrobot")


@pytest.mark.parametrize("n_linesearch", [2, 5])
def test_forward_seq_matches_sweep_bitwise(acrobot, n_linesearch):
    """forward="seq" picks the candidate forward="sweep" picks: the whole
    solves agree bitwise (same accepted steps, same trajectories)."""
    _, tp, x0s, us0 = acrobot
    kw = dict(us_init=t(us0), n_linesearch=n_linesearch)
    r_sweep = tbatched.solve_batched(tp, SolverParams(**ROW), t(x0s), forward="sweep", **kw)
    r_seq = tbatched.solve_batched(tp, SolverParams(**ROW), t(x0s), forward="seq", **kw)
    for f in ("xs", "us", "mu", "reg", "opt_constr", "opt_lag"):
        assert torch.equal(getattr(r_seq, f), getattr(r_sweep, f)), f


def test_linesearch_seq_steps_and_early_exit(acrobot, monkeypatch):
    """Per lane the same step as the sweep, including lanes that reject the
    whole ladder (step 0, incumbent kept); the ladder is walked only until
    every lane has accepted."""
    _, tp, x0s, us0 = acrobot
    xs = tp.rollout(t(x0s), t(us0))
    us = t(us0)
    mults = tal.init_multipliers(tp, xs)
    mu = torch.full((B,), 1e4, dtype=torch.float64)
    derivs = tp.derivatives(xs, us)
    k, K, ok, _ = tbatched._backward_multi_reg(derivs, mults.val, mults.jac, mu, mu * 0, 4)
    assert bool(ok.all())
    k = k.clone()
    k[1] = -50.0 * k[1]  # lane 1: an ascent direction, rejected at every step
    calls = []
    real = tbatched.feedback_rollout
    monkeypatch.setattr(
        tbatched, "feedback_rollout", lambda *a: (calls.append(a[-1]), real(*a))[1]
    )
    xs_q, us_q, step_q = tbatched._linesearch_seq(tp, xs, us, k, K, mults, mu, 4)
    assert calls == [1.0, 0.5, 0.25, 0.125]  # lane 1 never accepts
    xs_w, us_w, step_w = tbatched._linesearch_sweep(tp, xs, us, k, K, mults, mu, 4)
    assert torch.equal(step_q, step_w) and float(step_q[1]) == 0.0
    assert torch.equal(xs_q, xs_w) and torch.equal(us_q, us_w)
    assert torch.equal(us_q[1], us[1])
    calls.clear()
    keep = [0, 2, 3]
    _, _, step = tbatched._linesearch_seq(
        tp, xs[keep], us[keep], k[keep], K[keep],
        tal.AffineMults(*(m[keep] for m in mults)), mu[keep], 4,
    )  # fmt: skip
    assert len(calls) == int(-torch.log2(step.min())) + 1 < 4


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_matmul_precision_is_bit_exact_on_cpu(acrobot, precision):
    _, tp, x0s, us0 = acrobot
    before = torch.backends.cuda.matmul.allow_tf32
    kw = dict(us_init=t(us0), n_linesearch=2, forward="seq")
    ref = tbatched.solve_batched(tp, SolverParams(**ROW), t(x0s), **kw)
    got = tbatched.solve_batched(tp, SolverParams(**ROW), t(x0s), matmul_precision=precision, **kw)
    assert torch.equal(got.us, ref.us) and torch.equal(got.xs, ref.xs)
    assert torch.backends.cuda.matmul.allow_tf32 == before  # restored


# ------------------------------------------------------------ whole slice


def whole_slice(name):
    jp, tp, x0s, us0 = arm_case(name)
    jr = jbatched.solve_batched(
        jp, JParams(**ROW), jnp.asarray(x0s), us_init=jnp.asarray(us0),
        deriv="jvp", forward="seq", n_linesearch=2,
    )  # fmt: skip
    before = fd.LAUNCHES
    tr = tbatched.solve_batched(
        tp, SolverParams(**ROW), t(x0s), us_init=t(us0), deriv="kernel",
        backward="kernel", forward="seq", n_linesearch=2, matmul_precision="highest",
    )  # fmt: skip
    assert fd.LAUNCHES == before  # CPU tensors: the plain versions ran
    for f in ("us", "xs"):
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        scale = np.maximum(1.0, np.abs(ref).max(axis=(1, 2), keepdims=True))
        assert float((np.abs(got - ref) / scale).max()) <= 1e-8, f
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    np.testing.assert_array_equal(tr.reg.numpy(), np.asarray(jr.reg))
    np.testing.assert_allclose(tr.opt_constr.numpy(), np.asarray(jr.opt_constr), rtol=1e-9, atol=0)
    close_scaled(tr.opt_lag, jr.opt_lag, 1e-8)
    close_scaled(tr.mults.val, jr.mults.val, 1e-8)
    close_scaled(tr.fb_K, jr.fb_K, 1e-8)


def test_arm_slice_matches_jax_acrobot():
    """The slice as a whole on a 2-DoF arm with a FrameTarget: us/xs within
    1e-8 of each lane's scale, identical μ and reg, opt_constr 1e-9
    relative."""
    whole_slice("acrobot")


@pytest.mark.slow  # the JAX side's compile of the 7-DoF solve takes over a minute
def test_arm_slice_matches_jax_panda7():
    whole_slice("panda7")


# ------------------------------------------------------------ entry checks


def test_kernel_deriv_gates(acrobot):
    jp, tp, x0s, us0 = acrobot
    with pytest.raises(ValueError, match="matmul_precision"):
        tbatched.solve_batched(tp, SolverParams(**ROW), t(x0s), matmul_precision="bf16")
    second = problem_from_numpy(
        dict(spec_of(jp), second_order=True), device="cpu", dtype=torch.float64
    )
    # a second-order problem runs through deriv="kernel" (it used to raise) …
    one = SolverParams(**dict(ROW, max_iterations=1))
    kw = dict(us_init=t(us0), n_linesearch=2)
    r_k = tbatched.solve_batched(second, one, t(x0s), deriv="kernel", **kw)
    r_j = tbatched.solve_batched(second, one, t(x0s), deriv="jvp", **kw)
    assert bool(torch.isfinite(r_k.us).all())
    np.testing.assert_allclose(r_k.us.numpy(), r_j.us.numpy(), rtol=0, atol=1e-9)
    # … unless the model is not torque-actuated joint by joint
    import copy

    class Underactuated(type(second)):
        nu = property(lambda self: self.model.nv - 1)

    under = copy.copy(second)
    under.__class__ = Underactuated
    with pytest.raises(ValueError, match="nu == nv"):
        tbatched._kernel_derivatives(under)
    pend = torch_problem(jax_pendulum_problem(8, jnp.float64))
    with pytest.raises(ValueError, match="revolute/prismatic RobotModel"):
        tbatched.solve_batched(pend, SolverParams(**ROW), torch.zeros(2, 2, dtype=torch.float64),
                               deriv="kernel")  # fmt: skip
    # a quaternion-manifold model takes deriv="jvp"
    jm = jrobots.all_joints_test_model(dtype=jnp.float64)
    manifold = torch_problem(jax_arm_problem(jm, "tip", jm.neutral_configuration(), 4))
    x0 = torch.cat([manifold.model.neutral_configuration(), torch.zeros(manifold.model.nv, dtype=torch.float64)])
    with pytest.raises(ValueError, match="revolute/prismatic RobotModel"):
        tbatched.solve_batched(manifold, SolverParams(**ROW), x0[None], deriv="kernel")


def test_fx_fu_needs_analytic_jacobians(acrobot):
    _, tp, x0s, us0 = acrobot
    xs = tp.rollout(t(x0s), t(us0))

    class NoJacobians(torch.nn.Module):
        analytic_jacobians_ok = False
        model = tp.model

    import copy

    broken = copy.copy(tp)
    broken._modules = dict(tp._modules, dynamics=NoJacobians())
    fx = torch.zeros(B, H, tp.ndx, tp.ndx, dtype=torch.float64)
    fu = torch.zeros(B, H, tp.ndx, tp.nu, dtype=torch.float64)
    with pytest.raises(ValueError, match="analytic_jacobians_ok"):
        broken.derivatives(xs, t(us0), fx_fu=(fx, fu))
