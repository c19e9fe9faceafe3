"""ddp_tpu_torch's batch-major ``solve_vmap`` against ddp_tpu's
``jax.vmap(solve)``, f64 on the CPU: tests/test_pendulum_solve.py's
``test_solve_vmap_batch`` at its configuration and bars, a converged lane
frozen bit for bit, the per-lane retries of the backward pass and halvings
of the line search, the history, and tests/test_precise.py's
``test_storage_mode_vmaps`` through ``precise=…``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_aux_subsystems import make_problem as aux_problem
from test_pendulum_solve import HORIZON
from test_pendulum_solve import make_problem as pendulum_problem
from test_precise import make_problem as precise_problem
from torch_parity_helpers import random_spd_derivs, t, to_torch_derivs, torch_problem

from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver.riccati import backward_pass
from ddp_tpu_torch.solver.rollout import forward_pass
from ddp_tpu_torch.solver.solve import SolverParams, solve_vmap

jax.config.update("jax_enable_x64", True)

ANCHOR = dict(max_iterations=60, threshold=1e-9, mu=1e8)  # test_solve_vmap_batch
STAGGERED = dict(max_iterations=30, threshold=1e-6, mu=1e6)  # lanes converge at different rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_scaled_err(a, b):
    """max_t |a − b| of each lane over that lane's largest |b| (at least 1)."""
    a, b = np.asarray(a), np.asarray(b)
    axes = tuple(range(1, a.ndim))
    return np.abs(a - b).max(axis=axes) / np.maximum(np.abs(b).max(axis=axes), 1.0)


@pytest.fixture(scope="module")
def anchor():
    """test_solve_vmap_batch's solve (H = 200, full DDP, 4 lanes, f64) by
    ddp_tpu's jitted ``jax.vmap(solve)``, by its jitted ``solve`` lane by
    lane, and by the port's ``solve_vmap``."""
    jp = pendulum_problem()
    x0s = np.array([[q0, 0.0] for q0 in (-0.3, 0.0, 0.2, 0.5)])
    jsolve_one = jax.jit(lambda x: jsolve(jp, JParams(**ANCHOR), x))
    return dict(
        vmap=jax.jit(jax.vmap(lambda x: jsolve(jp, JParams(**ANCHOR), x)))(jnp.asarray(x0s)),
        lanes=[jsolve_one(jnp.asarray(x)) for x in x0s],
        port=solve_vmap(torch_problem(jp), SolverParams(**ANCHOR), t(x0s)),
    )


def test_solve_vmap_batch(anchor):
    """≙ test_solve_vmap_batch: every lane's final q within 1e-4 of 3.14;
    us within 1e-7 of each lane's largest |u| of ddp_tpu's ``jax.vmap``.

    Iterations and convergence are compared on the lanes where ddp_tpu
    itself takes one decision: its ``jax.vmap(solve)`` and its ``solve`` of
    the same lane agree there.  Past f64's floor the stopping test at 1e-9
    is a roundoff draw in ddp_tpu too (ROADMAP, faults in the reference):
    lane q0 = 0 stops at row 47 in its ``solve``, at none of 60 under its
    ``vmap``, with us within 1e-10 of each other's scale either way."""
    ref, lanes, res = anchor["vmap"], anchor["lanes"], anchor["port"]
    assert res.xs.shape == (4, HORIZON + 1, 2) and res.stats.iterations.shape == (4,)
    final_q = res.xs[:, -1, 0].numpy()
    assert np.all(np.abs(final_q - 3.14) < 1e-4), final_q
    assert lane_scaled_err(res.us, ref.us).max() <= 1e-7
    it, conv = np.asarray(ref.stats.iterations), np.asarray(ref.stats.converged)
    resolved = [i for i, r in enumerate(lanes) if int(r.stats.iterations) == it[i]
                and bool(r.stats.converged) == conv[i]]  # fmt: skip
    assert len(resolved) >= 3, resolved
    for i in resolved:
        assert int(res.stats.iterations[i]) == it[i], i
        assert bool(res.stats.converged[i]) == conv[i], i
    np.testing.assert_array_equal(res.stats.mu.numpy(), np.asarray(ref.stats.mu))


@pytest.fixture(scope="module")
def staggered():
    """The pendulum to q = 3.14 at H = 30 (full DDP, μ 1e6, 30 iterations,
    threshold 1e-6) from four starts whose lanes stop at different rows:
    the port's ``solve_vmap`` with its history, and ddp_tpu's."""
    jp = aux_problem(jnp.float64, horizon=30)
    x0s = np.array([[-0.3, 0.0], [0.0, 0.0], [0.5, 0.0], [1.0, 0.5]])
    ref = jax.jit(jax.vmap(lambda x: jsolve(jp, JParams(**STAGGERED), x, history=True)))(jnp.asarray(x0s))
    tp = torch_problem(jp)
    return dict(tp=tp, x0s=t(x0s), ref=ref, port=solve_vmap(tp, SolverParams(**STAGGERED), t(x0s), history=True))


def test_converged_lane_is_frozen_bit_for_bit(staggered):
    """A lane that converges before the others keeps its state bit for bit:
    the lane solved alone with ``max_iterations`` cut to the row where it
    stopped gives every field, stats and history rows included, of its lane
    in the whole batch (lanes do not interact, and nothing moves a done
    lane); its history rows after that repeat the converged row."""
    res = staggered["port"]
    it, conv = res.stats.iterations, res.stats.converged
    early = [i for i in range(4) if bool(conv[i]) and int(it[i]) < STAGGERED["max_iterations"]]
    assert early, (it, conv)
    for i in early:
        k = int(it[i])
        alone = solve_vmap(staggered["tp"], SolverParams(**dict(STAGGERED, max_iterations=k)),
                           staggered["x0s"][i:i + 1], history=True)  # fmt: skip
        leaves = lambda r: [r.xs, r.us, r.fb_k, r.fb_K, *r.mults, *r.stats]  # noqa: E731
        for a, b in zip(leaves(res), leaves(alone)):
            assert torch.equal(a[i], b[0])
        for a, b in zip(res.history, alone.history):
            assert torch.equal(a[i, :k], b[0])
            assert torch.equal(a[i, k:], a[i, k - 1:k].expand(STAGGERED["max_iterations"] - k))


def test_history_matches_ddp_tpu(staggered):
    """``history=True`` gives [B, I] rows; on the first 12 rows every lane's
    μ, reg, w, n, step and decisions are ddp_tpu's ``jax.vmap`` history's
    and its measures within 1e-5 relative.  (From row 14 roundoff parts the
    two packages' line-search decisions on this configuration, whose
    measures sit at f64's floor; the stopped rows differ from there.)"""
    ref, res = staggered["ref"].history, staggered["port"].history
    assert res.mu.shape == (4, STAGGERED["max_iterations"])
    for name in ("mu", "reg", "w", "n", "step", "upd_success", "upd_failure", "done"):
        np.testing.assert_array_equal(getattr(res, name)[:, :12].numpy(), np.asarray(getattr(ref, name))[:, :12])
    for name in ("opt_lag", "opt_constr"):
        np.testing.assert_allclose(getattr(res, name)[:, :12].numpy(), np.asarray(getattr(ref, name))[:, :12],
                                   rtol=1e-5)  # fmt: skip


@pytest.mark.parametrize("mode", ["storage", True])
def test_storage_mode_vmaps(mode):
    """≙ tests/test_precise.py::test_storage_mode_vmaps (its problem at
    H = 30, f32, 4 lanes, 12 iterations, μ 1e5, threshold 1e-7): every lane's
    ``opt_lag`` finite and ``opt_constr`` < 1e-3, through ``precise="storage"``
    and the envelope (``precise=True``); the results in float32."""
    tp = torch_problem(precise_problem(horizon=30, dtype=jnp.float32), np.float32)
    x0s = torch.tensor(np.stack([np.linspace(-0.3, 0.3, 4), np.zeros(4)], axis=1), dtype=torch.float32)
    res = solve_vmap(tp, SolverParams(max_iterations=12, threshold=1e-7, mu=1e5), x0s, precise=mode)
    assert res.us.dtype == res.stats.opt_lag.dtype == torch.float32 and res.us.shape == (4, 30, 1)
    assert torch.isfinite(res.stats.opt_lag).all()
    assert (res.stats.opt_constr < 1e-3).all()


def test_backward_pass_retries_per_lane():
    """A lane whose factorization fails climbs reg and μ alone: each lane of
    the batched pass gives the single-trajectory pass's μ, reg and ok, and
    its gains within 1e-12; a lane outside ``live`` does not retry."""
    f, pe, pex = random_spd_derivs(3, 6, 2, 1, 1, seed=4)
    f["luu"][1, 2] = -5.0  # lane 1 is not positive definite at reg 0
    d, pe, pex = to_torch_derivs(f), t(pe), t(pex)
    mu, reg = torch.full((3,), 10.0, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    res = backward_pass(d, pe, pex, mu, reg)
    for i in range(3):
        one = backward_pass(type(d)(*(x[i] for x in d)), pe[i], pex[i], mu[i], reg[i])
        assert float(res.mu[i]) == float(one.mu) and float(res.reg[i]) == float(one.reg)
        assert bool(res.ok[i]) == bool(one.ok)
        np.testing.assert_allclose(res.K[i].numpy(), one.K.numpy(), rtol=0, atol=1e-12)
    assert float(res.mu[1]) > 10.0 and float(res.mu[0]) == float(res.mu[2]) == 10.0
    held = backward_pass(d, pe, pex, mu, reg, live=torch.tensor([True, False, True]))
    assert not bool(held.ok[1]) and float(held.mu[1]) == 10.0


def test_forward_pass_halves_per_lane():
    """Each lane of the batched line search keeps its step once it accepts:
    the single-trajectory search's step, acceptance and rollout (within
    1e-12) for every lane, on gains scaled so that the lanes accept at
    different halvings."""
    tp = torch_problem(aux_problem(jnp.float64, horizon=10))
    x0s = torch.tensor([[0.1, 0.0], [0.4, 0.2], [-0.2, 0.1]], dtype=torch.float64)
    us = torch.zeros(3, 10, 1, dtype=torch.float64)
    xs = tp.rollout(x0s, us)
    mults = tal.init_multipliers(tp, xs)
    derivs = tp.derivatives(xs, us)
    mu = torch.full((3,), 1e3, dtype=torch.float64)
    bres = backward_pass(derivs, mults.val, mults.jac, mu, torch.zeros(3, dtype=torch.float64))
    k = bres.k * torch.tensor([1.0, 40.0, 3000.0], dtype=torch.float64)[:, None, None]
    res = forward_pass(tp, xs, us, k, bres.K, mults, mu)
    assert len(set(res.step.tolist())) == 3, res.step
    for i in range(3):
        one = forward_pass(tp, xs[i], us[i], k[i], bres.K[i], tal.AffineMults(*(m[i] for m in mults)), mu[i])
        assert float(res.step[i]) == float(one.step) and bool(res.accepted[i]) == bool(one.accepted)
        np.testing.assert_allclose(res.xs[i].numpy(), one.xs.numpy(), rtol=0, atol=1e-12)


def test_solve_vmap_preconditions():
    """A batch of states must be [B, nx], as ``solve``'s one state is [nx]."""
    tp = torch_problem(aux_problem(jnp.float64, horizon=4))
    with pytest.raises(AssertionError, match="x0s.ndim"):
        solve_vmap(tp, SolverParams(2, 1e-6, mu=1e4), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(AssertionError, match="x0s.shape"):
        solve_vmap(tp, SolverParams(2, 1e-6, mu=1e4), torch.zeros(3, 3, dtype=torch.float64))
