"""Parity: the port's one-launch whole solve (kernels/flat_solve.py, its plain
version on CPU tensors) vs ddp_tpu's solve_batched static flow (same gates,
same accepted steps, same multiplier schedule state) and vs ddp_tpu's Pallas
whole-solve kernel in interpret mode; the gates; the problem-as-data buffer."""

import gc
import json

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
from ddp_tpu_torch.ocp.constraints import AdvanceTime, ConfigTarget, every_k
from ddp_tpu_torch.ocp.dynamics import RK4Dynamics
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


# SolverParams.mu_max and mult_max at this file's size: n = 10 lets every
# lane update its multipliers in the first iteration (by μ·eq ≫ 20, so the
# cap clips them: the values under PRIMAL and PRIMAL_DUAL_CONSTANT, the
# Jacobians under PRIMAL_DUAL_AFFINE), and the next failure's μ·10 = 1e5 is
# cut to 3e4
CAPS = dict(PARAMS, n=10.0, mu_max=3e4, mult_max=20.0)


@pytest.mark.parametrize("method", ["PRIMAL", "PRIMAL_DUAL_CONSTANT", "PRIMAL_DUAL_AFFINE"])
def test_caps_match_jax_solve_batched(method):
    """The μ and multiplier caps: the port's solve_batched and the flat
    solve's plain version against ddp_tpu's solve_batched with both caps
    binding, μ identical."""
    jp, tp = both_problems(H, np.float64, target=1.0)
    x0s = x0s_small()
    kw = dict(method=JMethod[method], n_reg_levels=1, n_linesearch=8)
    jr = jbatched.solve_batched(jp, JParams(**CAPS), jnp.asarray(x0s), **kw)
    mu = np.asarray(jr.mu)
    assert bool((mu == CAPS["mu_max"]).all())  # the cap bound: μ·10 would be 1e5
    clipped = np.abs(np.asarray(jr.mults.jac if method == "PRIMAL_DUAL_AFFINE" else jr.mults.val))
    assert float(clipped.max()) == CAPS["mult_max"]
    params = SolverParams(**CAPS)
    own = tbatched.solve_batched(tp, params, t(x0s), **dict(kw, method=Method[method]))
    flat = flat_solve.solve_flat(tp, params, t(x0s), method=Method[method])
    for tr in (own, flat):
        assert_results_match(tr, jr)
        np.testing.assert_array_equal(tr.mu.numpy(), mu)


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


def test_plan_of_cpu_tensors_has_no_launch_and_no_scratch():
    """CPU tensors have no card to plan for: the plan packs the kernel's 10
    ints and 5 reals (both caps set) but asks for no launch plan and
    allocates no scratch; a program other than the kernel's two is refused."""
    _, tp = both_problems(4, np.float64, target=1.0)
    params = SolverParams(**PARAMS, mu_max=3e4, mult_max=20.0)
    x0s = t(x0s_small())
    plan = flat_solve.plan_launch(tp, params, x0s, n_linesearch=3, _program="streamed")
    assert plan.launch is None and plan.geometry == {} and plan.tensors[-1].numel() == 0
    assert plan.ints[:4] == [4, B, 3, 3] and plan.ints[7:9] == [1, 1] and len(plan.ints) == 10
    assert plan.reals[3:] == [3e4, 20.0]
    with pytest.raises(ValueError, match="program"):
        flat_solve.plan_launch(tp, params, x0s, _program="cached")


# ------------------------------------------------------------------- spans


def _spans(tmp_path, fn):
    """``fn()`` under the CPU profiler: its result and the trace's program
    spans as (name, start, end), in the order they opened."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    marks = [ev for ev in events if ev.get("cat") == "user_annotation" and ev["name"].startswith("solve_flat")]
    marks.sort(key=lambda ev: (ev["ts"], -ev["dur"]))
    return out, [(ev["name"], ev["ts"], ev["ts"] + ev["dur"]) for ev in marks]


def test_plan_launch_records_its_three_stages_in_order(tmp_path):
    _, tp = both_problems(4, np.float64, target=1.0)
    _, spans = _spans(tmp_path, lambda: flat_solve.plan_launch(tp, SolverParams(**PARAMS), t(x0s_small())))
    assert [name for name, _, _ in spans] == ["solve_flat.gates", "solve_flat.pack", "solve_flat.plan"]
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_solve_flat_records_its_root_with_the_pack_inside(tmp_path):
    _, tp = both_problems(4, np.float64, target=1.0)
    x0s = t(x0s_small())
    run = lambda: flat_solve.solve_flat(tp, SolverParams(**PARAMS), x0s, n_linesearch=3)  # noqa: E731
    traced, spans = _spans(tmp_path, run)
    assert [name for name, _, _ in spans] == ["solve_flat", "solve_flat.pack"]
    (_, s0, e0), (_, s1, e1) = spans
    assert s0 <= s1 and e1 <= e0
    plain = run()
    for name in FIELDS:
        assert torch.equal(getattr(traced, name), getattr(plain, name)), name
    assert torch.equal(traced.mults.val, plain.mults.val) and torch.equal(traced.mults.jac, plain.mults.jac)


# ------------------------------------------------------------------- the cache


def _uncached(problem, params, x0s, us_init=None, n_linesearch=8):
    """What a plan's shared inputs (us0, scal, consts, mrow), ints and reals
    are when packed afresh: ``pack_problem`` and ``_setup``, as the wrapper
    packed them on every call before it kept them."""
    _, T, m, e, ta, mrow, us, sc = flat_solve._setup(problem, params, x0s, us_init, None)
    kw = dict(dtype=x0s.dtype)
    tensors = [
        us.permute(1, 2, 0).contiguous(),
        torch.tensor([params.mu, params.reg, sc["w0"], sc["n0"]], **kw)[:, None].repeat(1, x0s.shape[0]),
        flat_problem.pack_problem(problem).consts,
        torch.tensor(mrow, **kw),
    ]  # fmt: skip
    ints = [T, x0s.shape[0], params.max_iterations, n_linesearch, ta, 1, 0,
            int(params.mu_max is not None), int(params.mult_max is not None), params.inner_iters_max]  # fmt: skip
    reals = [sc["threshold"], sc["w_min"], sc["mu_factor"], 0.0, 0.0]
    return tensors, ints, reals


def _leaf(problem):
    return next(m for m in problem.modules() if type(m) is ConfigTarget)


def _change(case, problem, params, x0s):
    """Apply ``case``'s change between two calls: the next call's (params,
    x0s, keyword arguments) and whether it has to pack the problem again."""
    kw = {}
    if case == "target_written_in_place":
        _leaf(problem).target.copy_(torch.tensor([2.0], dtype=torch.float64))
    elif case == "dt_reassigned":
        problem.dynamics.dt = torch.tensor(0.02, dtype=torch.float64)
    elif case == "integrator_swapped":  # the same buffers under another module type
        rk4 = RK4Dynamics(problem.dynamics.model, problem.dynamics.dt)
        for mod in [problem] + [m for m in problem.modules() if type(m) is AdvanceTime]:
            mod.dynamics = rk4
    elif case == "schedule_of_steps":
        _leaf(problem).active_ts = (3,)
    elif case == "schedule_every_k":
        _leaf(problem).active_ts = every_k(5, offset=3)
    elif case == "float32":
        problem.to(torch.float32)
        x0s = x0s.float()
    elif case == "params":
        params = params._replace(mu=1e3)
    elif case == "batch":
        x0s = x0s[:5]
    else:  # "us_init"
        kw = dict(us_init=t(np.random.default_rng(3).normal(size=(x0s.shape[0], 4, 1))))
    return params, x0s, kw, case not in ("params", "batch", "us_init")


@pytest.mark.parametrize(
    "case",
    ["target_written_in_place", "dt_reassigned", "integrator_swapped", "schedule_of_steps",
     "schedule_every_k", "float32", "params", "batch", "us_init"],
)  # fmt: skip
def test_plan_launch_packs_a_problem_once_and_again_after_a_change(case):
    """A second call on one problem packs nothing and shares the first's
    constant inputs; after ``case``'s change the next call packs again
    where the problem changed (a new launch shape only sets its constants
    up again), and its constant inputs, ints and reals are those of a fresh
    pack, bit for bit, and not the first call's."""
    _, tp = both_problems(4, np.float64, target=1.0)
    params, x0s = SolverParams(**PARAMS), t(x0s_small())
    flat_solve._CACHE.clear()
    packs = flat_solve.PACKS
    first = flat_solve.plan_launch(tp, params, x0s)
    second = flat_solve.plan_launch(tp, params, x0s)
    assert flat_solve.PACKS == packs + 1
    assert all(a is b for a, b in zip(first.tensors[1:5], second.tensors[1:5]))
    fresh = [x.data_ptr() for x in second.tensors[:1] + second.tensors[5:12]]
    assert not set(fresh) & {x.data_ptr() for x in first.tensors}  # x0, the outputs: new every call
    params, x0s, kw, repacks = _change(case, tp, params, x0s)
    third = flat_solve.plan_launch(tp, params, x0s, **kw)
    assert flat_solve.PACKS == packs + 1 + repacks
    tensors, ints, reals = _uncached(tp, params, x0s, **kw)
    for got, want in zip(third.tensors[1:5], tensors):
        assert got.dtype == want.dtype and torch.equal(got, want)
    build = flat_problem.pack_problem(tp).build
    assert third.ints == ints and third.reals == reals and third.flat.build == build
    stale = zip(first.tensors[1:5], tensors)
    assert (first.ints, first.reals, first.flat.build) != (ints, reals, build) or not all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) for a, b in stale
    )
    if case == "us_init":
        assert third.tensors[1] is not first.tensors[1]


def test_a_dropped_problem_drops_its_cache_entry():
    """The cache holds its problems weakly: once a problem is gone, so is
    its pack."""
    _, tp = both_problems(4, np.float64, target=1.0)
    flat_solve._CACHE.clear()
    flat_solve.plan_launch(tp, SolverParams(**PARAMS), t(x0s_small()))
    assert len(flat_solve._CACHE) == 1
    del tp
    gc.collect()
    assert len(flat_solve._CACHE) == 0


def test_problem_of_inference_tensors_packs_on_every_call():
    """Buffers made under ``torch.inference_mode`` keep no version counter,
    so no key could see them written in place: every call packs."""
    jp, _ = both_problems(4, np.float64, target=1.0)
    with torch.inference_mode():
        tp = problem_from_numpy(spec_of(jp), device="cpu", dtype=torch.float64)
    params, x0s = SolverParams(**PARAMS), t(x0s_small())
    packs = flat_solve.PACKS
    for _ in range(2):
        plan = flat_solve.plan_launch(tp, params, x0s)
    assert flat_solve.PACKS == packs + 2
    assert torch.equal(plan.tensors[3], flat_problem.pack_problem(tp).consts)


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
    # a cached problem gives what a fresh pack gives: the plan's constant
    # inputs and the whole solve, call after call
    params, x0s = SolverParams(**PARAMS), t(x0s_small())
    cached = [flat_solve.plan_launch(tp, params, x0s) for _ in range(3)]
    solves = [flat_solve.solve_flat(tp, params, x0s, n_linesearch=3) for _ in range(3)]
    for plan, solve in zip(cached, solves):
        flat_solve._CACHE.clear()
        fresh = flat_solve.plan_launch(tp, params, x0s)
        assert all(torch.equal(a, b) for a, b in zip(plan.tensors[1:5], fresh.tensors[1:5]))
        assert (plan.ints, plan.reals) == (fresh.ints, fresh.reals)
        flat_solve._CACHE.clear()
        again = flat_solve.solve_flat(tp, params, x0s, n_linesearch=3)
        for name in FIELDS:
            assert torch.equal(getattr(solve, name), getattr(again, name)), name
        assert torch.equal(solve.mults.val, again.mults.val) and torch.equal(solve.mults.jac, again.mults.jac)


def test_flat_problem_float32_buffer_follows_the_problem():
    _, tp = both_problems(5, np.float32)
    flat = flat_problem.pack_problem(tp)
    assert flat.consts.dtype == torch.float32
    assert float(flat.consts[-1]) == pytest.approx(3.14, rel=1e-6)
