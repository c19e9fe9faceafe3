"""``solve_batched(give_up_after=…)`` and the dead lanes of the early-exit
ladder against ddp_tpu, f64 on the CPU: ddp_tpu's
``test_give_up_after_freezes_racing_lane_only`` configuration (the pendulum
at T = 100, 12 iterations, μ 1e8, lane 0 a terminal μ-racer at μ = ∞,
``give_up_after=3``) through both packages, the line search's rollouts
counted in each (ddp_tpu's through a debug callback under ``jit``), and the
port's own guarantees: the healthy lanes bit for bit those of a solve without
give-up, no rollout when every lane is dead, the guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_batched_solver import make_problem
from torch_mesh_ranks import world_of_one
from torch_parity_helpers import torch_problem

import ddp_tpu.solver.batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.parallel import mesh as pm
from ddp_tpu_torch.solver import batched
from ddp_tpu_torch.solver.solve import SolverParams

jax.config.update("jax_enable_x64", True)

PARAMS = dict(max_iterations=12, threshold=1e-9, mu=1e8)
X0S = np.stack([[q, 0.0] for q in (-0.4, 0.0, 0.3, 0.5)])
MU0 = np.array([np.inf, 1e8, 1e8, 1e8])  # lane 0 races terminally
GIVE_UP = 3
N_CANDIDATES = 8  # solve_batched's default ladder
# At row 9 lane 1's line search weighs AL costs that differ by roundoff (its
# opt_obj is 3.5e-7 there): the port takes step ½ where ddp_tpu takes 1, by
# the summation order of its costs, with one thread or eight.  The accepted
# steps are compared on the rows before it; the controls stay within 1e-10.
STEPS_RESOLVED = 9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ladder_depths(steps):
    """Rollouts of each line-search call, from the step of every rollout in
    call order: a call starts at step 1 with every earlier call done."""
    depths = []
    for s in steps:
        if s == 1.0:
            depths.append(0)
        depths[-1] += 1
    return depths


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def jax_run(problem):
    """ddp_tpu's solve with give_up_after=3 under jit, and the step of each
    rollout its early-exit loop ran (its per-lane vmap calls the callback once
    a lane, and a lane whose loop is over repeats its last step; the loop's
    first trip is at step 1 on every lane)."""
    seen = []
    rollout = jbatched.feedback_rollout

    def spy(problem_, xs, us, k, K, step, **kw):
        jax.debug.callback(lambda s: seen.append(float(s)), step)
        return rollout(problem_, xs, us, k, K, step, **kw)

    jbatched.feedback_rollout = spy
    try:
        res = jax.jit(lambda x, m: jbatched.solve_batched(
            problem, JParams(**PARAMS), x, forward="seq", mu_init=m, give_up_after=GIVE_UP, history=True,
        ))(jnp.asarray(X0S), jnp.asarray(MU0))  # fmt: skip
        jax.block_until_ready(res.us)
    finally:
        jbatched.feedback_rollout = rollout
    B = X0S.shape[0]
    trips = [seen[i : i + B] for i in range(0, len(seen), B)]
    return res, ladder_depths([min(trip) for trip in trips])


def port_solve(problem, monkeypatch=None, **kw):
    """The port's solve of the configuration; with ``monkeypatch``, also the
    rollouts of each line-search call."""
    steps = []
    if monkeypatch is not None:
        rollout = batched.feedback_rollout

        def spy(problem_, xs, us, k, K, step):
            steps.append(float(step))
            return rollout(problem_, xs, us, k, K, step)

        monkeypatch.setattr(batched, "feedback_rollout", spy)
    res = batched.solve_batched(torch_problem(problem), SolverParams(**PARAMS), torch.tensor(X0S),
                                forward="seq", mu_init=torch.tensor(MU0), history=True, **kw)  # fmt: skip
    if monkeypatch is not None:
        monkeypatch.undo()
    return res, ladder_depths(steps)


@pytest.fixture(scope="module")
def port_runs(problem):
    mp = pytest.MonkeyPatch()
    return {g: port_solve(problem, mp, give_up_after=g) for g in (None, GIVE_UP)}


def test_give_up_matches_ddp_tpu(jax_run, port_runs):
    """≙ test_give_up_after_freezes_racing_lane_only against ddp_tpu: the
    healthy lanes' controls within 1e-10 of each lane's largest |u| and
    their accepted steps equal on the rows f64 resolves; the dead lane at
    μ = ∞ in both with finite controls and every step 0; and the same
    freezing row — the line search's depth, call by call, is ddp_tpu's (the
    full ladder while lane 0 is alive, then only what the healthy lanes
    need)."""
    (jr, j_depths), (tr, t_depths) = jax_run, port_runs[GIVE_UP]
    ju, tu = np.asarray(jr.us), tr.us.numpy()
    scale = np.maximum(np.abs(ju).max(axis=(1, 2)), 1.0)
    err = np.abs(ju - tu).max(axis=(1, 2)) / scale
    assert err[1:].max() <= 1e-10, err
    k = STEPS_RESOLVED
    np.testing.assert_array_equal(tr.history.step[:k, 1:].numpy(), np.asarray(jr.history.step[:k, 1:]))
    for r in (jr, tr):
        assert np.isinf(np.asarray(r.mu[0]))
        assert np.isfinite(np.asarray(r.us[0])).all()
        assert float(np.asarray(r.history.step[:, 0]).max()) == 0.0
    # the pre-loop call and one call an iteration; lane 0 holds the ladder
    # at full depth until its streak reaches 3 (after the pre-loop and rows
    # 0 and 1), so row 2 is the first it no longer holds
    assert len(t_depths) == len(j_depths) == 1 + PARAMS["max_iterations"]
    assert t_depths[: 1 + k] == j_depths[: 1 + k]
    freeze = GIVE_UP - 1
    assert t_depths[: 1 + freeze] == [N_CANDIDATES] * (1 + freeze)
    assert max(t_depths[1 + freeze :]) < N_CANDIDATES
    assert np.asarray(jr.opt_constr[1:]).max() < 1e-4


def test_give_up_leaves_healthy_lanes_bit_for_bit(port_runs):
    """The healthy lanes of the give-up solve are the bits of the solve
    without it; the dead lane keeps its reg from the row it froze, and
    without give-up it holds the ladder at full depth every call."""
    (base, base_depths), (gu, _) = port_runs[None], port_runs[GIVE_UP]
    for name in ("xs", "us", "mu", "reg", "w", "n", "opt_constr", "opt_lag"):
        assert torch.equal(getattr(gu, name)[1:], getattr(base, name)[1:]), name
    for name in ("step", "mu", "reg", "opt_constr", "upd_success", "upd_failure"):
        assert torch.equal(getattr(gu.history, name)[:, 1:], getattr(base.history, name)[:, 1:]), name
    freeze = GIVE_UP - 1
    reg0 = gu.history.reg[:, 0]
    assert bool((reg0[freeze:] == reg0[freeze - 1]).all())
    assert base_depths == [N_CANDIDATES] * (1 + PARAMS["max_iterations"])


def test_linesearch_seq_with_every_lane_dead_makes_no_rollout(problem, monkeypatch):
    """Every lane dead: no rollout at all, the incumbent back bit for bit at
    step 0.  No lane dead: the bits and the rollouts of ``dead=None``."""
    tp = torch_problem(problem)
    x0s = torch.tensor(X0S)
    us = torch.tensor(np.random.default_rng(0).standard_normal((4, tp.horizon, 1)))
    xs = tp.rollout(x0s, us)
    mults = batched.al_mod.init_multipliers(tp, xs)
    mu = torch.full((4,), 1e4, dtype=torch.float64)
    derivs = tp.derivatives(xs, us)
    k, K, _ = batched._backward_sweep(derivs, mults.val, mults.jac, mu, torch.zeros(4, dtype=torch.float64))
    calls = []
    rollout = batched.feedback_rollout
    monkeypatch.setattr(batched, "feedback_rollout", lambda *a: calls.append(a[-1]) or rollout(*a))
    args = (tp, xs, us, k, K, mults, mu, N_CANDIDATES)
    xs_d, us_d, step_d = batched._linesearch_seq(*args, dead=torch.ones(4, dtype=torch.bool))
    assert calls == []
    assert xs_d is xs and us_d is us and torch.equal(step_d, torch.zeros(4, dtype=torch.float64))
    got = batched._linesearch_seq(*args, dead=torch.zeros(4, dtype=torch.bool))
    n_live = len(calls)
    want = batched._linesearch_seq(*args)
    assert n_live >= 1 and len(calls) == 2 * n_live
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", [dict(forward="sweep"), dict(forward="kernel"), dict(give_up_after=0),
                                dict(give_up_after=-1)])  # fmt: skip
def test_give_up_after_guards(problem, kw):
    """give_up_after needs forward='seq' (as in ddp_tpu), and at least 1
    (ddp_tpu accepts 0 and freezes every lane, ROADMAP's deliberate
    differences)."""
    kw = dict(dict(forward="seq", give_up_after=GIVE_UP), **kw)
    with pytest.raises(ValueError, match="give_up_after"):
        batched.solve_batched(torch_problem(problem), SolverParams(**PARAMS), torch.tensor(X0S), **kw)


def test_ddp_tpu_give_up_after_guard(problem):
    """ddp_tpu raises the same ValueError for a forward other than 'seq'."""
    with pytest.raises(ValueError, match="give_up_after"):
        jbatched.solve_batched(problem, JParams(**PARAMS), jnp.asarray(X0S), give_up_after=GIVE_UP)


def test_give_up_after_through_the_sharded_solve(problem, port_runs):
    """``batch_sharded_solve_batched`` forwards give_up_after to
    solve_batched: at world size 1 the result is the unsharded one's bits."""
    gu, _ = port_runs[GIVE_UP]
    with world_of_one() as mesh:
        res, _ = pm.batch_sharded_solve_batched(
            torch_problem(problem), SolverParams(**PARAMS), mesh, forward="seq",
            mu_init=torch.tensor(MU0), give_up_after=GIVE_UP,
        )(torch.tensor(X0S))  # fmt: skip
        for name in ("xs", "us", "mu", "reg"):
            assert torch.equal(getattr(res, name).to_local(), getattr(gu, name)), name
