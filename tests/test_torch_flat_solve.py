"""Parity: the port's one-launch whole solve (kernels/flat_solve.py, its plain
version on CPU tensors) vs ddp_tpu's solve_batched static flow (same gates,
same accepted steps, same multiplier schedule state) and vs ddp_tpu's Pallas
whole-solve kernel in interpret mode; the gates; the problem-as-data buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.kernels.flat_solve import solve_flat_pallas
from ddp_tpu.models import robots as jrobots
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import Method as JMethod
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import flat_problem, flat_solve
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import Method, SolverParams

from torch_parity_helpers import (
    PANDA_READY,
    both_problems,
    headline_x0s,
    jax_arm_problem,
    jax_config_problem,
    spec_of,
    t,
    torch_problem,
)

FIELDS = ("us", "xs", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n")
# tests/test_flat_solve.py's case: H = 6, B = 8, 3 iterations, f64
H, B = 6, 8
PARAMS = dict(max_iterations=3, threshold=1e-9, mu=1e4, inner_iters_max=1)


def x0s_small():
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(-0.5, 0.5, B), np.zeros(B)], axis=1)


def assert_results_match(got, ref, atol=1e-11):
    """All twelve fields within ``atol`` of the reference, relative to each
    array's largest entry (the multipliers grow with μ, so an absolute bar
    would be below one ulp of them); ``opt_lag``, a residual of terms the size
    of the controls, relative to the largest |u|."""
    u_scale = max(1.0, float(np.max(np.abs(np.asarray(ref.us)))))
    pairs = [(n, getattr(got, n), getattr(ref, n)) for n in FIELDS]
    pairs += [("mults." + n, getattr(got.mults, n), getattr(ref.mults, n)) for n in ("val", "jac")]
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.size:
            scale = u_scale if name == "opt_lag" else max(1.0, float(np.max(np.abs(b))))
            assert float(np.max(np.abs(a - b))) <= atol * scale, name


@pytest.mark.parametrize("method", ["PRIMAL", "PRIMAL_DUAL_CONSTANT", "PRIMAL_DUAL_AFFINE"])
def test_reference_matches_jax_solve_batched(method):
    jp, tp = both_problems(H, np.float64, target=1.0)
    x0s = x0s_small()
    jr = jbatched.solve_batched(
        jp, JParams(**PARAMS), jnp.asarray(x0s), method=JMethod[method],
        n_reg_levels=1, n_linesearch=8,
    )  # fmt: skip
    tr = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s), method=Method[method])
    assert_results_match(tr, jr)
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    np.testing.assert_array_equal(tr.reg.numpy(), np.asarray(jr.reg))


def test_reference_matches_jax_solve_batched_unconstrained():
    jp, tp = both_problems(H, np.float64, target=None)
    rng = np.random.default_rng(1)
    x0s = x0s_small()
    us0 = 0.5 * rng.standard_normal((B, H, 1))
    jr = jbatched.solve_batched(
        jp, JParams(**PARAMS), jnp.asarray(x0s), us_init=jnp.asarray(us0),
        n_reg_levels=1, n_linesearch=8,
    )  # fmt: skip
    tr = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s), us_init=t(us0))
    assert tr.mults.val.shape == (B, H, 0) and tr.mults.jac.shape == (B, H, 0, 2)
    assert_results_match(tr, jr)
    assert float(np.max(np.abs(np.asarray(jr.us)))) < float(np.max(np.abs(us0)))  # it moved


@pytest.mark.parametrize("method", ["PRIMAL", "PRIMAL_DUAL_CONSTANT", "PRIMAL_DUAL_AFFINE"])
def test_reference_matches_solve_batched_once_multipliers_update(method):
    """The headline problem at H = 16, 8 iterations: lanes reach the target,
    multiplier updates succeed and lanes end at different μ, so the feedback
    term of the multiplier update and every gate are exercised.  Against
    ddp_tpu's solve_batched and the port's own.  The bar is 1e-8 of each
    array's scale: with μ at 1e7 to 1e9 and |u| up to 7e2, ddp_tpu's and the
    port's own solve_batched are themselves 1e-9 of that scale apart."""
    Hm, Bm = 16, 8
    params = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    jp, tp = both_problems(Hm, np.float64)
    x0s = headline_x0s(Bm, np.float64)
    kw = dict(n_reg_levels=1, n_linesearch=4)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(jp, JParams(**params), x, method=JMethod[method], **kw)
    )(x0s)
    tr = flat_solve.solve_flat(
        tp, SolverParams(**params), t(x0s), method=Method[method], n_linesearch=4
    )
    assert float(np.max(np.abs(np.asarray(jr.mults.val)))) > 1.0  # updates did succeed
    assert len(np.unique(np.asarray(jr.mu))) > 1
    assert_results_match(tr, jr, atol=1e-8)
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    if method != "PRIMAL_DUAL_AFFINE":
        assert bool((tr.mults.jac == 0).all())
    own = tbatched.solve_batched(
        tp, SolverParams(**params), t(x0s), method=Method[method], backward="kernel", **kw
    )
    assert_results_match(tr, own, atol=1e-8)
    assert torch.equal(tr.mu, own.mu)


@pytest.mark.parametrize("n_ls", [1, 7])
def test_reference_matches_solve_batched_at_candidate_counts(n_ls):
    """The headline problem as above at the fewest candidates the kernel
    takes and at the most its headline launch plan gives a group of 8
    threads: held to ddp_tpu's solve_batched and the port's own at the same
    bar, μ identical."""
    Hm, Bm = 16, 8
    params = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    jp, tp = both_problems(Hm, np.float64)
    x0s = headline_x0s(Bm, np.float64)
    kw = dict(n_reg_levels=1, n_linesearch=n_ls)
    jr = jax.jit(lambda x: jbatched.solve_batched(jp, JParams(**params), x, **kw))(x0s)
    tr = flat_solve.solve_flat(tp, SolverParams(**params), t(x0s), n_linesearch=n_ls)
    assert_results_match(tr, jr, atol=1e-8)
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    own = tbatched.solve_batched(tp, SolverParams(**params), t(x0s), backward="kernel", **kw)
    assert_results_match(tr, own, atol=1e-8)
    assert torch.equal(tr.mu, own.mu)


def test_reference_float32_reaches_the_target():
    Hm, Bm = 32, 16
    params = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    _, tp = both_problems(Hm, np.float32)
    tr = flat_solve.solve_flat(
        tp, SolverParams(**params), t(headline_x0s(Bm, np.float32)), n_linesearch=4
    )
    assert tr.xs.dtype == torch.float32
    for name in FIELDS:
        assert bool(torch.isfinite(getattr(tr, name)).all()), name
    assert float((tr.opt_constr < 1e-2).float().mean()) >= 0.9


@pytest.mark.slow  # ddp_tpu's whole-solve kernel traces for a minute in interpret mode
def test_reference_matches_pallas_interpret():
    jp, tp = both_problems(H, np.float64, target=1.0)
    x0s = x0s_small()
    jr = solve_flat_pallas(jp, JParams(**PARAMS), jnp.asarray(x0s), interpret=True)
    tr = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s))
    assert_results_match(tr, jr)


def test_nonpd_lanes_keep_their_incumbent():
    """A control-cost weight of −1e12 keeps Quu negative at every reg the
    budget reaches: no lane moves, reg escalates in every pass, the gains
    stay zero."""
    jp, _ = both_problems(H, np.float64, target=1.0)
    tp = problem_from_numpy(dict(spec_of(jp), c=-1e12), device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(2)
    x0s, us0 = t(x0s_small()), t(0.1 * rng.standard_normal((B, H, 1)))
    tr = flat_solve.solve_flat(tp, SolverParams(**PARAMS), x0s, us_init=us0)
    assert torch.equal(tr.us, us0) and torch.equal(tr.xs, tp.rollout(x0s, us0))
    assert bool((tr.fb_k == 0).all()) and bool((tr.fb_K == 0).all())
    assert bool((tr.reg >= 2.0**4 * 1e4).all())  # ×2 from max(reg, μ) in each of 4 passes
    assert bool(torch.isfinite(tr.opt_lag).all())


def test_one_bad_lane_leaves_the_others_alone():
    """Lane 3 starts at a NaN state, so none of its pivots is positive: it
    keeps its controls and escalates its reg while every other lane solves
    exactly as it does without it."""
    _, tp = both_problems(H, np.float64, target=1.0)
    x0s = x0s_small()
    bad = x0s.copy()
    bad[3, 0] = np.nan
    good = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s))
    mixed = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(bad))
    keep = np.arange(B) != 3
    for name in FIELDS:
        assert torch.equal(getattr(mixed, name)[keep], getattr(good, name)[keep]), name
    assert bool((mixed.us[3] == 0).all()) and float(mixed.reg[3]) > 0 == float(good.reg[3])


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, tp = both_problems(H, np.float64, target=1.0)
    x0s = t(x0s_small())
    before = flat_solve.LAUNCHES
    got = flat_solve.solve_flat(tp, SolverParams(**PARAMS), x0s, n_linesearch=3)
    ref = flat_solve.solve_flat_reference(tp, SolverParams(**PARAMS), x0s, n_linesearch=3)
    assert flat_solve.LAUNCHES == before
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(got.mults.val, ref.mults.val)
    assert torch.equal(got.mults.origin, got.xs[:, :-1])


# ------------------------------------------------------------------- gates


def _gate_cases():
    jp, tp = both_problems(4, np.float64, target=1.0)
    second = problem_from_numpy(
        dict(spec_of(jp), second_order=True), device="cpu", dtype=torch.float64
    )
    two_steps = problem_from_numpy(
        dict(spec_of(jp), active_ts=(3, 4)), device="cpu", dtype=torch.float64
    )
    cart = torch_problem(
        jax_config_problem(jrobots.cartpole(dtype=jnp.float64), [0.3, 0.2], 4)
    )
    arm = torch_problem(
        jax_arm_problem(jrobots.panda7(dtype=jnp.float64), "ee", PANDA_READY, 4)
    )
    return {
        "second_order": (second, "Gauss-Newton"),
        "two_active_steps": (two_steps, "single-active-step"),
        "robot_model": (cart, "RobotModel model is not in the flat-lane class"),
        "frame_target": (arm, "FrameTarget on a RobotModel"),
    }


@pytest.mark.parametrize(
    "case", ["second_order", "two_active_steps", "robot_model", "frame_target"]
)
def test_gates_raise_value_error_naming_the_reason(case):
    problem, reason = _gate_cases()[case]
    x0s = torch.zeros((2, problem.nx), dtype=torch.float64)
    with pytest.raises(ValueError, match=reason):
        flat_solve.solve_flat(problem, SolverParams(**PARAMS), x0s)


def test_bad_arguments_raise():
    _, tp = both_problems(4, np.float64, target=1.0)
    x0s = torch.zeros((2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="n_linesearch"):
        flat_solve.solve_flat(tp, SolverParams(**PARAMS), x0s, n_linesearch=0)
    with pytest.raises(ValueError, match="float32"):
        flat_solve.solve_flat(tp, SolverParams(**PARAMS), x0s.float())
    with pytest.raises(ValueError, match="x0s must be"):
        flat_solve.solve_flat(tp, SolverParams(**PARAMS), torch.zeros((2, 3), dtype=torch.float64))


# ------------------------------------------------------- the problem as data


@pytest.mark.parametrize("target", [1.25, None])
def test_flat_problem_buffer_round_trips_the_spec(target):
    """The headline's class as data: Euler, the control cost, and (unless
    unconstrained) one configuration-target leaf behind its two layers of
    the problem's own dynamics; the spec read back from the buffer builds a
    problem that packs to the same buffer, mask and structure."""
    jp, tp = both_problems(5, np.float64, target=target)
    flat = flat_problem.pack_problem(tp)
    spec = spec_of(jp)
    assert flat.build == {"DYN": 0, "COST": 0, "E": 0 if target is None else 1}
    assert (flat.nx, flat.m, flat.e) == (2, 1, 0 if target is None else 1)
    own = [spec["mass"], spec["length"], spec["dt"]]
    expected = own + [spec["c"]]
    if target is None:
        expected += [0.0]  # no leaf
    else:  # one leaf: config, 2 layers at [10, 18), its target at [18]
        layer = [0.0, spec["dt"], spec["mass"], spec["length"]]  # Euler, dt, mass, length
        expected += [1.0, 0.0, 2.0, 10.0, 18.0, 1.0] + 2 * layer + [target]
    np.testing.assert_array_equal(flat.consts.numpy(), expected)
    assert flat.consts.dtype == torch.float64 and flat.consts.is_contiguous()
    np.testing.assert_array_equal(flat.mask, tp.eq_mask())
    if target is not None:
        assert spec["advance_times"] == 2
        assert tp.active_ts() == (3,) and flat.active_ts == (3,)
    # … and back: the spec read from the buffer builds the same problem
    again = flat_problem.pack_problem(
        problem_from_numpy(flat.spec(), device="cpu", dtype=torch.float64)
    )
    assert torch.equal(again.consts, flat.consts) and again.build == flat.build
    assert again.tree == flat.tree
    np.testing.assert_array_equal(again.mask, flat.mask)


def test_flat_problem_float32_buffer_follows_the_problem():
    _, tp = both_problems(5, np.float32)
    flat = flat_problem.pack_problem(tp)
    assert flat.consts.dtype == torch.float32
    assert float(flat.consts[-1]) == pytest.approx(3.14, rel=1e-6)
