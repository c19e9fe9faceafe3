"""ddp_tpu_torch's main-path slice against ddp_tpu on the same inputs:
rollout, derivatives, AL terms, the backward backends and the whole batched
headline solve (bench.py's configuration at a small batch), in float64 on the
CPU, plus the f32 feasibility bar."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ddp_tpu.models import base as jbase
from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.solver import al as jal
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver import rollout as jrollout
from ddp_tpu.solver.riccati import factor_solve as jax_factor_solve
from ddp_tpu.solver.solve import Method as JMethod
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.models import base as tbase
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver import rollout as trollout
from ddp_tpu_torch.solver.riccati import factor_solve
from ddp_tpu_torch.solver.solve import Method, SolverParams

from torch_parity_helpers import (
    both_problems,
    headline_x0s,
    random_spd_derivs,
    spec_of,
    t,
    to_jax_derivs,
    to_torch_derivs,
)

REPO = Path(__file__).resolve().parent.parent
B, H = 8, 32
# bench.py's headline schedule: 8 fixed AL iterations, bounded inner loop
HEADLINE = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
HEADLINE_KW = dict(n_reg_levels=1, n_linesearch=4)


def close(got, ref, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol, err_msg=err_msg
    )


# ---------------------------------------------------------------- components


@pytest.fixture(scope="module")
def traj():
    """Both problems and one numpy-seeded trajectory (the JAX rollout's xs
    feeds both packages' derivative code)."""
    jp, tp = both_problems(H, np.float64)
    rng = np.random.default_rng(11)
    x0s = headline_x0s(B, np.float64)
    us = 0.3 * rng.normal(size=(B, H, 1))
    xs = np.asarray(jax.jit(jax.vmap(jp.rollout))(x0s, us))
    return jp, tp, x0s, us, xs


@pytest.fixture(scope="module")
def derivs_pair(traj):
    jp, tp, _, us, xs = traj
    return jax.jit(jax.vmap(jp.derivatives))(xs, us), tp.derivatives(t(xs), t(us))


@pytest.fixture(scope="module")
def mults(traj):
    """Non-trivial affine multipliers anchored at a perturbed trajectory."""
    _, _, _, _, xs = traj
    rng = np.random.default_rng(12)
    return jal.AffineMults(
        val=0.3 * rng.normal(size=(B, H, 1)),
        jac=0.1 * rng.normal(size=(B, H, 1, 2)),
        origin=xs[:, :-1] + 0.01 * rng.normal(size=(B, H, 2)),
    )


def test_problem_from_numpy_carries_the_problem(traj):
    jp, tp, *_ = traj
    dims = ("nx", "ndx", "nu", "ne", "horizon")
    assert [getattr(tp, d) for d in dims] == [getattr(jp, d) for d in dims]
    np.testing.assert_array_equal(tp.eq_mask(), jp.eq_mask())
    assert tp.active_ts() == jp.active_ts() == (H - 2,)
    assert not tp.second_order
    assert problem_from_numpy(
        dict(spec_of(jp), second_order=True), device="cpu", dtype=torch.float64
    ).second_order


def test_rollout(traj):
    _, tp, x0s, us, xs = traj
    close(tp.rollout(t(x0s), t(us)), xs, atol=1e-12)


@pytest.mark.parametrize("field", JDerivs._fields)
def test_derivs_field(derivs_pair, field):
    jd, td = derivs_pair
    ref, got = np.asarray(getattr(jd, field)), getattr(td, field)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float64
    close(got, ref, atol=1e-12, err_msg=field)


def test_constraint_rows_only_at_the_active_step(derivs_pair):
    _, td = derivs_pair
    active = torch.zeros(H, dtype=torch.bool)
    active[H - 2] = True
    assert bool((td.eq[:, ~active] == 0).all()) and bool((td.eq[:, active] != 0).all())
    assert bool((td.equ[:, active] != 0).all())


def test_eq_mask_takes_row_mask_and_keeps_the_schedule():
    """A constraint's ``row_mask`` decides the activity mask in both packages
    (here it drops every other step of its schedule), a ``range`` schedule is
    kept as given, and the flat-lane packer refuses what lies outside its
    class: the subclass, and a schedule that cannot be listed."""
    import dataclasses

    from ddp_tpu.ocp import constraints as jcons
    from ddp_tpu.ocp.problem import Problem as JProblem
    from ddp_tpu_torch.kernels.flat_problem import pack_problem
    from ddp_tpu_torch.ocp import constraints as tcons
    from ddp_tpu_torch.ocp.problem import Problem as TProblem

    Hm = 12

    def every_fourth(con, t):
        return np.array([t in con.active_ts and t % 4 == 0])

    @dataclasses.dataclass(frozen=True)
    class JRowMasked(jcons.ConfigTarget):
        row_mask = every_fourth

    class TRowMasked(tcons.ConfigTarget):
        row_mask = every_fourth

    class Odd:  # a schedule that answers `t in` and cannot be listed
        def __contains__(self, t):
            return t % 2 == 1

    jp, tp = both_problems(Hm, np.float64)
    schedule = range(0, Hm, 2)
    jcon = JRowMasked(model=jp.model, target=jp.constraint.inner.inner.target, active_ts=schedule)
    tcon = TRowMasked(tp.model, tp.constraint.inner.inner.target, schedule)
    assert tcon.active_ts is schedule
    jmask = JProblem(dynamics=jp.dynamics, cost=jp.cost, constraint=jcon, horizon=Hm).eq_mask()
    tprob = TProblem(tp.dynamics, tp.cost, tcon, Hm)
    np.testing.assert_array_equal(tprob.eq_mask(), jmask)
    assert jmask[:, 0].tolist() == [float(t % 4 == 0) for t in range(Hm)]
    assert tprob.active_ts() == (0, 4, 8)
    with pytest.raises(ValueError, match="TRowMasked"):
        pack_problem(tprob)
    plain = tcons.ConfigTarget(tp.model, tcon.target, schedule)
    assert pack_problem(TProblem(tp.dynamics, tp.cost, plain, Hm)).active_ts == (0, 2, 4, 6, 8, 10)
    odd = TProblem(tp.dynamics, tp.cost, tcons.ConfigTarget(tp.model, tcon.target, Odd()), Hm)
    assert odd.active_ts() == tuple(range(1, Hm, 2))
    with pytest.raises(ValueError, match="Odd schedule"):
        pack_problem(odd)


def test_update_origin(traj, mults):
    jp, tp, _, _, xs = traj
    ref = jax.vmap(lambda m_, x: jal.update_origin(jp.model, m_, x))(mults, xs)
    got = tal.update_origin(tp.model, tal.AffineMults(*map(t, mults)), t(xs))
    for name in ("val", "jac", "origin"):
        close(getattr(got, name), getattr(ref, name), atol=1e-12, err_msg=name)


def test_state_transport(traj):
    jp, tp, _, _, xs = traj
    v = np.random.default_rng(14).normal(size=2)
    ref = jbase.state_transport(jp.model, v, xs[0, 3], xs[1, 5])
    close(tbase.state_transport(tp.model, t(v), t(xs[0, 3]), t(xs[1, 5])), ref, atol=1e-12)


def test_feedback_rollout(traj):
    jp, tp, _, us, xs = traj
    rng = np.random.default_rng(15)
    k, K = 0.1 * rng.normal(size=(B, H, 1)), 0.1 * rng.normal(size=(B, H, 1, 2))
    xs_old = xs + 0.01 * rng.normal(size=xs.shape)
    ref = jax.vmap(lambda x, u, k_, K_: jrollout.feedback_rollout(jp, x, u, k_, K_, 0.5))(
        xs_old, us, k, K
    )
    got = trollout.feedback_rollout(tp, t(xs_old), t(us), t(k), t(K), 0.5)
    close(got[0], ref[0], atol=1e-12)
    close(got[1], ref[1], atol=1e-12)


def test_unconstrained_problem_derivatives():
    """ne = 0 (NoConstraint): zero-width constraint blocks, no active step."""
    from ddp_tpu.ocp import constraints as jcon
    from ddp_tpu.ocp.problem import Problem as JProblem
    from ddp_tpu_torch.ocp import constraints as tcon
    from ddp_tpu_torch.ocp.problem import Problem as TProblem

    jp0, tp0 = both_problems(8, np.float64)
    jp = JProblem(jp0.dynamics, jp0.cost, jcon.NoConstraint(), 8, second_order=False)
    tp = TProblem(tp0.dynamics, tp0.cost, tcon.NoConstraint(), 8, second_order=False)
    rng = np.random.default_rng(16)
    x0s, us = rng.normal(size=(3, 2)), rng.normal(size=(3, 8, 1))
    xs = np.asarray(jax.vmap(jp.rollout)(x0s, us))
    jd, td = jax.vmap(jp.derivatives)(xs, us), tp.derivatives(t(xs), t(us))
    assert tp.active_ts() == () and tuple(td.eq.shape) == (3, 8, 0)
    for name in JDerivs._fields:
        close(getattr(td, name), getattr(jd, name), atol=1e-12, err_msg=name)


def test_eval_mults(traj, mults):
    jp, tp, _, _, xs = traj
    ref = jax.vmap(lambda m_, x: jal.eval_mults(jp.model, m_, x))(mults, xs)
    got = tal.eval_mults(tp.model, tal.AffineMults(*map(t, mults)), t(xs))
    close(got, ref, atol=1e-12)


def test_al_costs(traj, mults):
    jp, tp, _, us, xs = traj
    mu = 10.0 ** np.random.default_rng(13).uniform(0, 1, B)
    ref = jax.vmap(lambda x, u, m_, mu_: jal.al_costs(jp, x, u, m_, mu_))(xs, us, mults, mu)
    got = tal.al_costs(tp, t(xs), t(us), tal.AffineMults(*map(t, mults)), t(mu))
    assert tuple(got.shape) == (B, H + 1)
    close(got, ref, atol=1e-12)


def test_optimality_measures(traj, derivs_pair, mults):
    jp, tp, _, _, xs = traj
    jd, td = derivs_pair
    jm = jax.vmap(lambda m_, x: jal.update_origin(jp.model, m_, x))(mults, xs)
    tm = tal.update_origin(tp.model, tal.AffineMults(*map(t, mults)), t(xs))
    mu = np.full((B,), 1e3)
    ref_oo = jax.vmap(lambda d, v, j, m_: jal.optimality_obj(jp, d, v, j, m_))(
        jd, jm.val, jm.jac, mu
    )
    ref_ol = jax.vmap(lambda d, v, j: jal.optimality_lag(jp, d, v, j))(jd, jm.val, jm.jac)
    close(tal.optimality_obj(tp, td, tm.val, tm.jac, t(mu)), ref_oo, atol=1e-12)
    close(tal.optimality_lag(tp, td, tm.val, tm.jac), ref_ol, atol=1e-12)
    close(tal.optimality_constr(td), jax.vmap(jal.optimality_constr)(jd), atol=1e-12)


def test_factor_solve_nan_on_non_pd():
    rng = np.random.default_rng(5)
    G = rng.normal(size=(6, 3, 3))
    A = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(3)
    A[2] = -np.eye(3)
    r1, r2 = rng.normal(size=(6, 3)), rng.normal(size=(6, 3, 2))
    ok_j, x1_j, x2_j = jax.vmap(jax_factor_solve)(A, r1, r2)
    ok_t, x1_t, x2_t = factor_solve(t(A), t(r1), t(r2))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not bool(ok_t[2]) and bool(torch.isnan(x1_t[2]).all())
    keep = np.arange(6) != 2
    close(x1_t[keep], np.asarray(x1_j)[keep], atol=1e-12, rtol=1e-12)
    close(x2_t[keep], np.asarray(x2_j)[keep], atol=1e-12, rtol=1e-12)


def test_reg_ladder_backends_match_jax():
    """n_reg_levels=4 with one lane indefinite at reg=0: both port backends
    pick the same ladder level, gains and reg as ddp_tpu's sweep ladder."""
    Bl, T = 4, 6
    fields, pe, pex = random_spd_derivs(Bl, T, 2, 1, 1, seed=21)
    fields["luu"][1] = -100.0
    mu, reg = np.full((Bl,), 1e3), np.zeros(Bl)
    k_j, K_j, ok_j, reg_j = jax.vmap(
        lambda d, v, j, m_, r: jbatched._backward_multi_reg(d, v, j, m_, r, n_levels=4)
    )(to_jax_derivs(fields), pe, pex, mu, reg)
    assert bool(np.all(ok_j)) and np.asarray(reg_j)[1] > 0 and np.asarray(reg_j)[0] == 0
    args = (to_torch_derivs(fields), t(pe), t(pex), t(mu), t(reg), 4)
    for backend in (tbatched._backward_multi_reg, tbatched._backward_kernel_levels):
        k, K, ok, reg_u = backend(*args)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(reg_u.numpy(), np.asarray(reg_j))
        close(k, k_j, atol=1e-10, rtol=1e-10)
        close(K, K_j, atol=1e-10, rtol=1e-10)


def test_gate_critical_stages_run_in_full_fp32(monkeypatch):
    """``matmul_precision="high"`` allows TF32 for the solve, but the Riccati
    sweep, the optimality adjoints and ``update_origin`` run inside
    ``al.full_fp32_matmuls`` with TF32 off, as ddp_tpu pins them to
    "highest", and so do the line search's rollouts and AL cost, on both
    eager line searches (sweep and seq); the process setting comes back after
    the solve, and after the guard even when its body raises."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.setdefault(name, set()).add(torch.backends.cuda.matmul.allow_tf32)
            return fn(*a, **kw)

        return wrapped

    # tmv: the sweep and the adjoints; state_difference_jacobian:
    # update_origin alone; mv: update_origin and the line search's AL cost
    for name in ("tmv", "state_difference_jacobian", "mv"):
        monkeypatch.setattr(tal, name, spy(name, getattr(tal, name)))
    _, tp = both_problems(8, np.float64)
    before = torch.backends.cuda.matmul.allow_tf32
    params = SolverParams(max_iterations=2, threshold=1e-5, mu=1e4, inner_iters_max=1)
    for forward in ("sweep", "seq"):
        tbatched.solve_batched(
            tp, params, t(headline_x0s(4, np.float64)), matmul_precision="high",
            forward=forward, **HEADLINE_KW,
        )  # fmt: skip
    assert seen["tmv"] == {False} and seen["state_difference_jacobian"] == {False}
    assert seen["mv"] == {False}  # the line search's AL cost is pinned too
    assert torch.backends.cuda.matmul.allow_tf32 == before
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="inside"):
        with tal.full_fp32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32


# ------------------------------------------------------------- whole solve


@pytest.fixture(scope="module")
def headline_f64():
    """bench.py's headline solve at B=8, f64: the port's kernel backend (its
    plain version on the CPU) and ddp_tpu's Pallas backend in interpret mode."""
    jp, tp = both_problems(H, np.float64)
    x0s = headline_x0s(B, np.float64)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(
            jp, JParams(**HEADLINE), x, backward="pallas", interpret=True, **HEADLINE_KW
        )
    )(x0s)
    tr = tbatched.solve_batched(
        tp, SolverParams(**HEADLINE), t(x0s), backward="kernel", **HEADLINE_KW
    )
    return jr, tr, tp, x0s


@pytest.mark.parametrize("field", ["xs", "us", "fb_k", "fb_K"])
def test_headline_f64_matches_pallas(headline_f64, field):
    jr, tr, *_ = headline_f64
    close(getattr(tr, field), getattr(jr, field), atol=1e-9, err_msg=field)


@pytest.mark.parametrize("field", ["val", "jac"])
def test_headline_f64_multipliers_match_pallas(headline_f64, field):
    """The multipliers grow with μ (up to 1e9 here, |jac| ~ 1e7, where one f64
    ulp is already ~1e-9), so the 1e-9 bar is taken relative to each array's
    largest entry."""
    jr, tr, *_ = headline_f64
    ref = np.asarray(getattr(jr.mults, field))
    got = getattr(tr.mults, field).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-9 * max(1.0, np.max(np.abs(ref)))


def test_headline_f64_schedule_state_matches_pallas(headline_f64):
    jr, tr, *_ = headline_f64
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    assert len(np.unique(np.asarray(jr.mu))) > 1  # lanes end at different μ
    for name in ("reg", "w", "n"):
        close(getattr(tr, name), getattr(jr, name), atol=0.0, rtol=1e-12, err_msg=name)
    close(tr.opt_constr, jr.opt_constr, atol=1e-12)
    assert bool((tr.opt_constr < 1e-2).all())


def test_headline_f64_sweep_backend_matches_kernel_backend(headline_f64):
    _, tr, tp, x0s = headline_f64
    sw = tbatched.solve_batched(
        tp, SolverParams(**HEADLINE), t(x0s), backward="sweep", **HEADLINE_KW
    )
    close(sw.us, tr.us, atol=1e-9)
    np.testing.assert_array_equal(sw.mu.numpy(), tr.mu.numpy())


def test_headline_f32_feasibility_matches_jax_sweep():
    """f32 at B=64: the same feasible fraction as ddp_tpu's sweep, and the
    swing-up reaches the target within test_batched_float32's bar."""
    Bf = 64
    jp, tp = both_problems(H, np.float32)
    x0s = headline_x0s(Bf, np.float32)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(jp, JParams(**HEADLINE), x, **HEADLINE_KW)
    )(x0s)
    tr = tbatched.solve_batched(
        tp, SolverParams(**HEADLINE), t(x0s), backward="kernel", **HEADLINE_KW
    )
    assert tr.xs.dtype == torch.float32 and bool(torch.isfinite(tr.us).all())
    feas_t = float((tr.opt_constr < 1e-2).float().mean())
    assert feas_t == float(np.mean(np.asarray(jr.opt_constr) < 1e-2))
    close(tr.xs[:, -1, 0], jr.xs[:, -1, 0], atol=5e-2)


@pytest.mark.parametrize("method", ["PRIMAL", "PRIMAL_DUAL_CONSTANT"])
def test_non_affine_methods_match_jax(method):
    Bm, Hm = 4, 16
    jp, tp = both_problems(Hm, np.float64)
    x0s = headline_x0s(Bm, np.float64)
    params = dict(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(
            jp, JParams(**params), x, method=JMethod[method], n_linesearch=4
        )
    )(x0s)
    tr = tbatched.solve_batched(
        tp, SolverParams(**params), t(x0s), method=Method[method], n_linesearch=4
    )
    close(tr.us, jr.us, atol=1e-9)
    close(tr.mults.val, jr.mults.val, atol=1e-9, rtol=1e-12)
    assert bool((tr.mults.jac == 0).all())
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))


# ------------------------------------------------------------ entry checks


@pytest.mark.parametrize(
    "kw",
    [
        # what the ported backends refuse, naming the first knob:
        # backward="assoc" a second_order problem (as ddp_tpu does),
        # precise_cost the line-search kernel (which ddp_tpu's
        # forward="pallas" leaves unread); the JAX names of the kernel
        # backends are unknown values here ("kernel" replaced "pallas"), and
        # the fd-derivatives kernel refuses the closed-form pendulum.  The
        # ids are the ones these cases had when the first two were still
        # unported (their "slice" named the work that ported them)
        pytest.param(dict(backward="assoc", second_order=True), id="kw0-slice H"),
        pytest.param(dict(precise_cost=True, backward="tf", forward="kernel"), id="kw1-slice G"),
        pytest.param(dict(forward="pallas"), id="kw2-Queue 2"),
        pytest.param(dict(deriv="pallas"), id="kw3-ValueError"),
        pytest.param(dict(deriv="kernel"), id="kw4-ValueError"),
    ],
)
def test_deferred_backends_raise(traj, kw):
    jp, tp, x0s, _, _ = traj
    kw = dict(kw)
    if kw.pop("second_order", False):
        tp = problem_from_numpy(dict(spec_of(jp), second_order=True), device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match=next(iter(kw))):
        tbatched.solve_batched(tp, SolverParams(**HEADLINE), t(x0s), **kw)


def test_bad_inputs_raise(traj):
    jp, tp, x0s, us, xs = traj
    with pytest.raises(ValueError, match="backward"):
        tbatched.solve_batched(tp, SolverParams(**HEADLINE), t(x0s), backward="pallas")
    with pytest.raises(ValueError, match="float32"):
        tbatched.solve_batched(tp, SolverParams(**HEADLINE), t(x0s).float())
    # the reference's three preconditions, through ddp_assert as in ddp_tpu
    for bad_x0s, params, failed in (
        (t(x0s[0]), HEADLINE, "x0s.ndim = 1 == 2"),
        (t(np.zeros((2, 3))), HEADLINE, "x0s state dim = 3 == 2"),
        (t(x0s), dict(HEADLINE, max_iterations=0), "max_iterations = 0 >= 1"),
    ):
        with pytest.raises(AssertionError, match="solve_batched\\(\\) preconditions") as exc:
            tbatched.solve_batched(tp, SolverParams(**params), bad_x0s)
        assert f"[FAILED] {failed}" in str(exc.value)
    # a second-order problem's derivatives work (they used to raise); what
    # raises is precomputed Jacobians without the dynamics Hessian
    second = problem_from_numpy(
        dict(spec_of(jp), second_order=True), device="cpu", dtype=torch.float64
    )
    d2 = second.derivatives(t(xs), t(us))
    d1 = tp.derivatives(t(xs), t(us))
    assert float(d2.fxx.abs().max()) > 0 and float(d1.fxx.abs().max()) == 0
    assert torch.equal(d2.fx, d1.fx) and torch.equal(d2.lxx, d1.lxx)
    with pytest.raises(ValueError, match="without f_hess"):
        second.derivatives(t(xs), t(us), fx_fu=(d1.fx, d1.fu))


def test_port_imports_no_jax_and_builds_nothing():
    code = (
        "import sys, importlib, pkgutil, ddp_tpu_torch\n"
        "for m in pkgutil.walk_packages(ddp_tpu_torch.__path__, 'ddp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ddp_tpu_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'triton', 'ddp_tpu')]\n"
        "assert not bad, bad\n"
        "assert not _build._LOADED\n"
        "from ddp_tpu_torch.utils import native\n"
        "assert native._lib is None and not native._tried\n"
        "for m in ('ops.lie', 'models.rigid_body', 'models.robots', 'kernels.fd_derivs',\n"
        "          'kernels.fd_derivs2', 'models.urdf', 'models.reduced', 'utils.native',\n"
        "          'utils.checkpoint', 'solver.mpc', 'diagnostics.checks',\n"
        "          'diagnostics.profiling', 'solver.parallel_riccati', 'solver.precise'):\n"
        "    assert 'ddp_tpu_torch.' + m in sys.modules, m\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    pat = re.compile(r"^\s*(import|from)\s+(jax|ddp_tpu|triton)(\.|\s|$)", re.M)
    for path in (REPO / "ddp_tpu_torch").rglob("*.py"):
        if "_build" not in path.parts:  # build outputs, not the package
            assert not pat.search(path.read_text()), path
