"""ddp_tpu_torch's diagnostics (``diagnostics/profiling.py``,
``diagnostics/checks.py``) and ``solve_batched(history=True)`` against
ddp_tpu on the same inputs, f64 on the CPU (≙ tests/test_aux_subsystems.py's
diagnostics tests and tests/test_history.py's trace and batched-history
tests)."""

import numpy as np
import pytest
import torch
from torch_parity_helpers import jax_pendulum_problem, t, torch_problem

import jax
import jax.numpy as jnp

from ddp_tpu.diagnostics import checks as jchecks
from ddp_tpu.diagnostics import profiling as jprof
from ddp_tpu.solver.batched import solve_batched as jsolve_batched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch.diagnostics import checks, profiling
from ddp_tpu_torch.solver.batched import BatchSolveHistory, solve_batched
from ddp_tpu_torch.solver.solve import SolveHistory, SolverParams, solve

jax.config.update("jax_enable_x64", True)

F64 = dict(dtype=torch.float64)
RESULT_FIELDS = ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n")
# test_history.py's solve: both packages' rows agree up to the first line
# search that weighs a cost change at f64's noise floor (row 9; measured in
# ddp_tpu against itself jitted and op by op, tests/test_torch_solve.py)
SOLVE_ROWS_RESOLVED = 9


@pytest.fixture(scope="module")
def pendulum_h40():
    """test_aux_subsystems.py's problem (H = 40, full DDP) in both packages."""
    jp = jax_pendulum_problem(40, jnp.float64, second_order=True)
    return jp, torch_problem(jp)


# ------------------------------------------------------------------ checks


def test_assert_finite_raises():
    checks.assert_finite({"a": torch.ones(3)})
    checks.assert_finite({"a": torch.ones(3), "skipped": None})
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]\[1\]"):
        checks.assert_finite({"a": (torch.ones(2), torch.tensor([1.0, torch.nan]))}, "bad")
    with pytest.raises(FloatingPointError, match=r"carry\.mu"):
        from ddp_tpu_torch.solver.mpc import MPCCarry

        checks.assert_finite(MPCCarry(torch.zeros(2), None, torch.tensor(torch.inf), torch.zeros(())), "carry")
    # ddp_tpu names the same leaf the same way
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]\[1\]"):
        jchecks.assert_finite({"a": (jnp.ones(2), jnp.asarray([1.0, jnp.nan]))}, "bad")


def test_nan_debug_mode_traps_new_nans_only():
    """The dispatch-mode counterpart of ``jax_debug_nans``: an op that makes
    a NaN from finite inputs raises, one that carries an input's NaN on does
    not; off again, nothing raises."""
    nan = torch.tensor([1.0, torch.nan])
    checks.nan_debug_mode(True)
    try:
        checks.nan_debug_mode(True)  # idempotent
        _ = nan + 1.0
        with pytest.raises(FloatingPointError, match="NaN produced"):
            torch.zeros(2) / torch.zeros(2)
        with pytest.raises(FloatingPointError, match="NaN produced"):
            torch.sqrt(torch.tensor([-1.0]))
    finally:
        checks.nan_debug_mode(False)
    assert bool(torch.isnan(torch.zeros(2) / torch.zeros(2)).all())


def test_derivative_self_check(pendulum_h40):
    """≙ test_aux_subsystems.py::test_derivative_self_check: the Taylor check
    passes on the correct full-DDP derivatives with ddp_tpu's bars, fails on
    a corrupted fx, and its residuals are of the order of ddp_tpu's (the
    random tangents differ: the port draws from a torch.Generator)."""
    jp, tp = pendulum_h40
    us = 0.1 * np.ones((40, 1))
    xs = np.asarray(jp.rollout(jnp.asarray([0.3, 0.0]), jnp.asarray(us)))
    jrep = jchecks.check_derivatives(jp, jnp.asarray(xs), jnp.asarray(us), eps=1e-6)
    rep = checks.check_derivatives(tp, t(xs), t(us), eps=1e-6)
    assert bool(rep.ok) and bool(jrep.ok)
    assert float(rep.f_first_order) < 1e-4
    assert float(rep.f_second_order) < 1e-7
    for field in ("f_first_order", "eq_first_order"):
        ratio = float(getattr(rep, field)) / float(getattr(jrep, field))
        assert 0.1 < ratio < 10.0, (field, ratio)
    assert float(rep.l_first_order) < 1e-4 and float(jrep.l_first_order) < 1e-4

    def corrupted(xs_, us_):
        d = type(tp).derivatives(tp, xs_, us_)
        return d._replace(fx=1.01 * d.fx)

    tp.derivatives = corrupted
    try:
        bad = checks.check_derivatives(tp, t(xs), t(us), eps=1e-6)
    finally:
        del tp.derivatives
    assert not bool(bad.ok) and float(bad.f_first_order) > 1e-3


# --------------------------------------------------------------- profiling


def test_chronometer_and_trace(tmp_path):
    log = str(tmp_path / "chrono.log")
    with profiling.chronometer("unit-test phase", path=log, sync={"x": torch.ones(8).sum()}):
        _ = torch.ones(8).sum()
    assert "unit-test phase" in open(log).read()

    tr = profiling.ConvergenceTrace("unit", directory=str(tmp_path))
    tr.record(1e-3, 1e-2)
    tr.record(torch.tensor(1e-5, **F64), torch.tensor(1e-4, **F64))
    assert len(open(tr.primal).read().splitlines()) == 2
    assert open(tr.dual).read().splitlines() == ["0.01", "0.0001"]

    res, seconds = profiling.timed_block_until_ready(lambda x: x * 2, torch.ones(3), n_rep=2)
    assert torch.equal(res, 2 * torch.ones(3)) and seconds >= 0.0
    with profiling.device_profile(str(tmp_path / "trace")):
        _ = torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "trace" / "trace.json").exists()


@pytest.fixture(scope="module")
def solve_histories():
    """test_history.py's solve (horizon 100, μ₀ = 1e6, 40 iterations, full
    DDP) with history in both packages."""
    jp = jax_pendulum_problem(100, jnp.float64, second_order=True)
    tp = torch_problem(jp)
    kw = dict(max_iterations=40, threshold=1e-9, mu=1e6)
    rj = jax.jit(lambda x: jsolve(jp, JParams(**kw), x, history=True))(jnp.zeros(2))
    rt = solve(tp, SolverParams(**kw), torch.zeros(2, **F64), history=True)
    return rj, rt


def test_history_feeds_convergence_trace(tmp_path, solve_histories):
    """≙ test_history.py::test_history_feeds_convergence_trace:
    ConvergenceTrace.record_history writes one primal/dual line per executed
    iteration; format_history gives ddp_tpu's text for the same history
    values, and the port's history rows are ddp_tpu's on the rows f64
    resolves."""
    rj, rt = solve_histories
    h = rt.history
    trace = profiling.ConvergenceTrace("hist_test", directory=str(tmp_path))
    trace.record_history(h)
    done = h.done.numpy()
    n_expected = int(done.argmax()) + 1 if done.any() else done.shape[0]
    primal = (tmp_path / "hist_test_primal.dat").read_text().strip().splitlines()
    dual = (tmp_path / "hist_test_dual.dat").read_text().strip().splitlines()
    assert len(primal) == n_expected and len(dual) == n_expected
    assert float(primal[-1]) == float(h.opt_constr[n_expected - 1])

    text = profiling.format_history(h)
    assert len(text.splitlines()) == n_expected + 1  # header + rows
    assert "mu*=10" in text or "p+=mu*eq" in text
    # the same values render to the same text in both packages
    same = SolveHistory(*(torch.from_numpy(np.array(a)) for a in rj.history))
    assert profiling.format_history(same) == jprof.format_history(rj.history)
    jtrace = jprof.ConvergenceTrace("jax", directory=str(tmp_path))
    jtrace.record_history(rj.history)
    trace_same = profiling.ConvergenceTrace("port", directory=str(tmp_path))
    trace_same.record_history(same)
    for kind in ("primal", "dual"):
        assert (tmp_path / f"port_{kind}.dat").read_text() == (tmp_path / f"jax_{kind}.dat").read_text()

    k = SOLVE_ROWS_RESOLVED
    for field in SolveHistory._fields:
        a, b = np.asarray(getattr(rj.history, field))[:k], getattr(h, field)[:k].numpy()
        if a.dtype == bool or field in ("mu", "reg"):
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * scale, err_msg=field)


# ------------------------------------------------------- batched history


@pytest.fixture(scope="module")
def batched_histories():
    """test_history.py::test_batched_history_records_schedule's solve (H =
    100, full DDP, 5 iterations, B = 4) in both packages, with and without
    the history."""
    jp = jax_pendulum_problem(100, jnp.float64, second_order=True)
    tp = torch_problem(jp)
    kw = dict(max_iterations=5, threshold=1e-9, mu=1e5, inner_iters_max=1)
    x0s = np.stack([np.asarray([0.1 * i, 0.0]) for i in range(4)])
    rj = jax.jit(lambda x: jsolve_batched(jp, JParams(**kw), x, history=True))(jnp.asarray(x0s))
    rh = solve_batched(tp, SolverParams(**kw), t(x0s), history=True)
    r0 = solve_batched(tp, SolverParams(**kw), t(x0s))
    return SolverParams(**kw), rj, rh, r0


def test_batched_history_records_schedule(batched_histories):
    """≙ test_history.py::test_batched_history_records_schedule: [I, B]
    fields, the last row the final carried μ, exclusive updates, μ never
    falling; history off by default."""
    params, _, res, res0 = batched_histories
    h = res.history
    assert isinstance(h, BatchSolveHistory)
    I, B = params.max_iterations, 4
    assert h.mu.shape == (I, B) and h.opt_constr.shape == (I, B)
    np.testing.assert_array_equal(h.mu[-1].numpy(), res.mu.numpy())
    np.testing.assert_array_equal(h.reg[-1].numpy(), res.reg.numpy())
    assert not bool((h.upd_success & h.upd_failure).any())
    mus = h.mu.numpy()
    assert np.all(mus[1:] >= mus[:-1] - 1e-12)
    assert bool(torch.isfinite(h.opt_obj).all())
    assert res0.history is None


def test_batched_history_matches_ddp_tpu(batched_histories):
    """Every recorded field against ddp_tpu's: μ, reg and both update flags
    equal, the rest within 1e-9 of each array's scale; recording leaves the
    result bit for bit what it is without."""
    _, rj, rh, r0 = batched_histories
    for field in BatchSolveHistory._fields:
        a, b = np.asarray(getattr(rj.history, field)), getattr(rh.history, field).numpy()
        assert a.shape == b.shape, field
        if a.dtype == bool or field in ("mu", "reg"):
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * scale, err_msg=field)
    assert bool(rh.history.upd_success.any()) and bool(rh.history.upd_failure.any())
    for field in RESULT_FIELDS:
        assert torch.equal(getattr(rh, field), getattr(r0, field)), field
    for a, b in zip(rh.mults, r0.mults):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ native


def test_native_chrono_log_and_failure_report(tmp_path, capfd):
    """``utils/native.py`` as ddp_tpu's: the C++ chronometer and log write
    the same lines through both packages' libraries, and a failed
    ``ddp_assert`` also reaches the native colored reporter on stderr."""
    from ddp_tpu.utils import native as jnative
    from ddp_tpu_torch.diagnostics.asserts import ddp_assert, val
    from ddp_tpu_torch.utils import native

    assert native.load() is not None, "the native runtime did not build"
    for pkg, mod in (("port", native), ("jax", jnative)):
        log = str(tmp_path / f"{pkg}.log")
        with mod.NativeChrono("native phase", path=log) as chrono:
            pass
        assert chrono.elapsed is not None and chrono.elapsed >= 0.0
        assert mod.native_log(log, "a line\n")
        lines = open(log).read().splitlines()
        assert lines[0].startswith("done [native phase] in ") and lines[0].endswith(" ms")
        assert lines[1] == "a line"
    with pytest.raises(AssertionError):
        ddp_assert(val(1, "one") == 2, msg="native report")
    err = capfd.readouterr().err
    assert "assertion (all_of)" in err and "native report" in err
