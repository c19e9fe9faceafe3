"""ddp_tpu_torch's precision envelope as float64 (solver/precise.py:
``solve_batched(backward="tf", precise_cost=True)``, ``solve(precise=True)``
and ``solve(precise="storage")``) on the CPU, at the bars of
tests/test_precise.py and tests/test_batched_solver.py's precise-cost anchor,
against ddp_tpu's float64 stages on the same inputs where a comparison is
cheap.  ddp_tpu's own double-float solves are not rerun here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.solver import al as jal
from ddp_tpu.solver.batched import _backward_sweep as jbackward_sweep
from ddp_tpu_torch import SolverParams, solve
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.base import state_pack
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver import precise
from ddp_tpu_torch.solver.batched import _backward_multi_reg, _reg_levels, solve_batched
from ddp_tpu_torch.solver.riccati import backward_sweep

from torch_parity_helpers import jax_pendulum_problem, spec_of, t

F32, F64 = torch.float32, torch.float64
EPS32 = float(np.finfo(np.float32).eps)


def make_problem(horizon=40, dtype=F64, target=3.14):
    """tests/test_precise.py's problem: the pendulum to ``target`` two steps
    past the horizon, dt = 0.01, ½‖u‖², from ddp_tpu's spec."""
    spec = spec_of(jax_pendulum_problem(horizon, jnp.float64, target=target))
    return problem_from_numpy(dict(spec, second_order=False), device="cpu", dtype=dtype)


def one(derivs):
    """A batch-of-one Derivs without its batch dim."""
    return type(derivs)(*(f[0] for f in derivs))


def test_f64_sweep_beats_f32_vs_f64_oracle():
    """≙ test_tf_backward_sweep_beats_f32_vs_f64_oracle: the float64 sweep on
    float32 inputs, gains rounded to float32, against ddp_tpu's float64 sweep
    of the same (float32-rounded) inputs: at the float32 rounding floor of
    the outputs (2·eps₃₂ of the largest gain) and well inside the plain
    float32 sweep's error."""
    T, mu = 100, 1e7
    p64 = make_problem(T)
    us = 0.05 * torch.sin(torch.arange(float(T), dtype=F64))[None, :, None]
    xs = p64.rollout(torch.tensor([[0.4, 0.0]], dtype=F64), us)
    d32 = one(p64.derivatives(xs, us))
    d32 = type(d32)(*(f.to(F32) for f in d32))
    m = tal.init_multipliers(p64, xs[0])
    v32, j32 = m.val.to(F32), m.jac.to(F32)
    mu32, reg32 = torch.tensor(mu, dtype=F32), torch.tensor(0.0, dtype=F32)
    k32, K32, ok32, _ = backward_sweep(d32, v32, j32, mu32, reg32)
    ktf, Ktf, oktf = precise.backward_sweep(d32, v32, j32, mu32, reg32)
    assert bool(ok32) and bool(oktf) and ktf.dtype == F32
    k64, K64, _ = jbackward_sweep(
        jax.tree.map(lambda a: jnp.asarray(a.numpy(), jnp.float64), d32),
        jnp.asarray(v32.numpy(), jnp.float64), jnp.asarray(j32.numpy(), jnp.float64),
        jnp.float64(mu), jnp.float64(0.0),
    )  # fmt: skip
    k64, K64 = t(k64), t(K64)
    err32 = float((k32.double() - k64).abs().max())
    errtf = float((ktf.double() - k64).abs().max())
    errK32 = float((K32.double() - K64).abs().max())
    errKtf = float((Ktf.double() - K64).abs().max())
    scale = float(k64.abs().max())
    assert errtf <= 2 * EPS32 * scale, (errtf, scale)
    assert errtf < 0.25 * err32, (errtf, err32)
    assert errKtf < 0.5 * errK32, (errKtf, errK32)


def test_f64_al_cost_resolves_sub_eps_deltas():
    """≙ test_tf_al_cost_resolves_sub_eps_deltas: a 1e-7 change of a ~4.6e6
    AL total (a last-step control moved by 1e-5) is lost in the float32 sum
    and recovered by the float64 one, within 1e-2 of ddp_tpu's float64
    oracle (the anchor's bar for double-float is 0.25)."""
    p32 = make_problem(40, F32)
    x0 = torch.tensor([0.3, 0.0])
    us_a = 0.01 * torch.ones(40, 1)
    us_b = us_a.clone()
    us_b[39, 0] += 1e-5
    xs_a, xs_b = p32.rollout(x0, us_a), p32.rollout(x0, us_b)
    mults = tal.init_multipliers(p32, xs_a)
    mu = torch.tensor(1e6)
    twin = precise.twin(p32)
    delta = float(precise.al_cost_total(twin, xs_b, us_b, mults, mu) - precise.al_cost_total(twin, xs_a, us_a, mults, mu))
    d32 = float(tal.al_costs(p32, xs_b, us_b, mults, mu).sum() - tal.al_costs(p32, xs_a, us_a, mults, mu).sum())
    assert d32 == 0.0, d32
    jp = jax_pendulum_problem(40, jnp.float32)
    jm = jax.tree.map(lambda a: jnp.asarray(a.numpy(), jnp.float64), jal.AffineMults(*mults))

    def total(xs, us):
        return jnp.sum(jal.al_costs(jp, jnp.asarray(xs.numpy()), jnp.asarray(us.numpy(), jnp.float64),
                                    jm, jnp.float64(1e6)).astype(jnp.float64))  # fmt: skip

    d64 = float(total(xs_b, us_b) - total(xs_a, us_a))
    assert delta != 0.0
    np.testing.assert_allclose(delta, d64, rtol=1e-2)
    assert next(p32.buffers()).dtype == F32  # the twin is a copy


def test_f64_mult_accumulation_tracks_f64():
    """≙ test_tf_mult_accumulation_tracks_f64: the two accumulating multiplier
    recurrences (update_origin's val += jac·(x ⊖ origin) and p += μ·Δ) over
    300 small steps on an O(1e4) base, run as ``solve(precise=True)`` runs
    them, track a numpy float64 oracle of the same float32-representable data
    ≥ 10× closer than the plain float32 recurrences."""
    rng = np.random.default_rng(3)
    T, ne, K, mu = 16, 2, 300, 1.0
    r32 = lambda a: np.asarray(np.asarray(a, np.float32), np.float64)  # noqa: E731
    val0 = r32(rng.normal(0, 1e4, (T, ne)))
    jac0 = r32(rng.normal(0, 1e4, (T, ne, 2)))
    xs_all = [r32(rng.normal(0, 1.0, (T + 1, 2)))]
    for _ in range(K):
        xs_all.append(r32(xs_all[-1] + r32(rng.normal(0, 1e-5, (T + 1, 2)))))
    incs_v = r32(rng.normal(0, 1e-2, (K, T, ne)))
    incs_j = r32(rng.normal(0, 1e-2, (K, T, ne, 2)))

    val, jac, origin = val0.copy(), jac0.copy(), xs_all[0][:-1]
    for k in range(K):  # the pendulum's state space is a vector space
        val = val + np.einsum("toj,tj->to", jac, xs_all[k + 1][:-1] - origin) + mu * incs_v[k]
        jac, origin = jac + mu * incs_j[k], xs_all[k + 1][:-1]

    p32 = make_problem(T, F32)
    env = precise.Envelope(p32)
    f = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    gain = torch.tensor(mu, dtype=F32)
    m_env = precise.wide(tal.AffineMults(f(val0), f(jac0), f(xs_all[0][:-1])))
    m_plain = tal.AffineMults(f(val0), f(jac0), f(xs_all[0][:-1]))
    for k in range(K):
        xs = f(xs_all[k + 1])
        m_env = env.mult_update(env.update_origin(m_env, xs), gain, f(incs_v[k]), f(incs_j[k]), None)
        m_plain = tal.update_origin(p32.model, m_plain, xs)
        m_plain = m_plain._replace(val=m_plain.val + mu * f(incs_v[k]), jac=m_plain.jac + mu * f(incs_j[k]))
    e_f64 = np.abs(m_env.val.numpy() - val).max()
    e_plain = np.abs(m_plain.val.double().numpy() - val).max()
    assert m_env.val.dtype == F64 and env.view(m_env).val.dtype == F32
    assert e_f64 < e_plain / 10.0, (e_f64, e_plain)


def test_f64_optimality_matches_ddp_tpu_f64():
    """≙ test_tf_optimality_matches_f64: ``solve(precise=True)``'s opt_lag on
    float32 derivatives (float64 adjoints, rounded to float32) against
    ddp_tpu's float64 optimality_lag of float64 copies of them, at 1e-6 (the
    anchor's double-float bar is 1e-5)."""
    p32 = make_problem(30, F32)
    xs = p32.rollout(torch.tensor([0.2, 0.0]), 0.02 * torch.ones(30, 1))
    us = 0.02 * torch.ones(30, 1)
    derivs = one(p32.derivatives(xs[None], us[None]))
    mults = tal.init_multipliers(p32, xs)
    env = precise.Envelope(p32)
    lag = env.opt_lag(derivs, precise.wide(mults))
    assert lag.dtype == F32
    jd = JDerivs(*(jnp.asarray(f.numpy(), jnp.float64) for f in derivs))
    lag64 = jal.optimality_lag(None, jd, jnp.asarray(mults.val.numpy(), jnp.float64),
                               jnp.asarray(mults.jac.numpy(), jnp.float64))  # fmt: skip
    np.testing.assert_allclose(float(lag), float(lag64), rtol=1e-6)


def test_tf_ladder_matches_ddp_tpu_f64_sweep():
    """One ``backward="tf"`` call (the reg ladder over the float64 sweep) on
    float32 inputs with one lane that only the ladder's second level saves:
    ok and reg_used as the float32-rounded ladder gives them, gains within
    2·eps₃₂ of each array's largest entry of ddp_tpu's float64 sweep at each
    lane's chosen level."""
    p32 = make_problem(20, F32)
    rng = np.random.default_rng(4)
    x0s = torch.tensor(0.3 * rng.standard_normal((3, 2)), dtype=F32)
    us = torch.tensor(0.4 * rng.standard_normal((3, 20, 1)), dtype=F32)
    xs = p32.rollout(x0s, us)
    derivs = p32.derivatives(xs, us)
    luu = derivs.luu.clone()
    luu[1] = -5e3  # fails at reg and at 2·max(reg, μ) = 2e3, holds at 3.2e4
    derivs = derivs._replace(luu=luu)
    val = torch.tensor(0.3 * rng.standard_normal((3, 20, 1)), dtype=F32)
    jac = torch.tensor(0.1 * rng.standard_normal((3, 20, 1, 2)), dtype=F32)
    mu, reg = torch.full((3,), 1e3), torch.zeros(3)
    k, K, ok, reg_used = _backward_multi_reg(derivs, val, jac, mu, reg, 4, sweep=precise.backward_sweep)
    levels = torch.stack(_reg_levels(mu, reg, 4))
    assert bool(ok.all()) and k.dtype == F32
    np.testing.assert_array_equal(reg_used.numpy(), [0.0, float(levels[2, 1]), 0.0])
    for b in range(3):
        kj, Kj, okj = jbackward_sweep(
            jax.tree.map(lambda a: jnp.asarray(a[b].numpy(), jnp.float64), derivs),
            jnp.asarray(val[b].numpy(), jnp.float64), jnp.asarray(jac[b].numpy(), jnp.float64),
            jnp.float64(1e3), jnp.float64(reg_used[b]),
        )  # fmt: skip
        assert bool(okj)
        assert float((k[b].double() - t(kj)).abs().max()) <= 2 * EPS32 * float(np.abs(kj).max())
        assert float((K[b].double() - t(Kj)).abs().max()) <= 2 * EPS32 * float(np.abs(Kj).max())


def test_batched_tf_backend_full_solve():
    """≙ test_batched_tf_backend_full_solve: backward="tf" with
    precise_cost=True is a drop-in batched backend (4 lanes, H = 30, 12
    iterations, f32); the caller's problem keeps its dtype."""
    p32 = make_problem(30, F32)
    x0s = torch.tensor([[q, 0.0] for q in (-0.4, 0.0, 0.3, 0.6)])
    res = solve_batched(p32, SolverParams(12, 1e-5, mu=1e4), x0s, backward="tf", precise_cost=True)
    assert bool(torch.isfinite(res.us).all()) and res.us.dtype == F32
    np.testing.assert_allclose(res.xs[:, -1, 0].numpy(), 3.14, atol=5e-2)
    assert all(b.dtype == F32 for b in p32.buffers())


def test_forward_seq_precise_cost_matches_sweep():
    """≙ test_batched_solver.py::test_forward_seq_precise_cost_matches_sweep:
    the early-exit ladder and the parallel sweep accept the same steps with
    float64 acceptance sums (H = 100, 8 iterations, 4 lanes, f32, equal us);
    the line-search kernel refuses precise_cost, which ddp_tpu's
    forward="pallas" leaves unread."""
    p32 = make_problem(100, F32)
    params = SolverParams(8, 1e-5, mu=1e4, inner_iters_max=1)
    x0s = torch.tensor([[0.1 * i, 0.0] for i in range(4)])
    ref = solve_batched(p32, params, x0s, precise_cost=True)
    seq = solve_batched(p32, params, x0s, forward="seq", precise_cost=True)
    np.testing.assert_array_equal(seq.us.numpy(), ref.us.numpy())
    with pytest.raises(ValueError, match="precise_cost"):
        solve_batched(p32, params, x0s, forward="kernel", precise_cost=True)


@pytest.fixture(scope="module")
def solves_t60():
    """tests/test_precise.py's T = 60 configuration (x0 = 0, mu = 1e6, 40
    iterations): the plain float32 solve and the envelope at threshold
    1e-7, the storage mode at 1e-9, and the float64 solve."""
    p32, p64 = make_problem(60, F32), make_problem(60, F64)
    x0 = torch.zeros(2)
    out = dict(
        plain=solve(p32, SolverParams(40, 1e-7, mu=1e6), x0),
        envelope=solve(p32, SolverParams(40, 1e-7, mu=1e6), x0, precise=True),
        storage=solve(p32, SolverParams(40, 1e-9, mu=1e6), x0, precise="storage"),
        f64=solve(p64, SolverParams(40, 1e-7, mu=1e6), torch.zeros(2, dtype=F64)),
    )
    assert all(b.dtype == F32 for b in p32.buffers())  # the twins were copies
    return out


def test_precise_solve_tightens_f32_floor(solves_t60):
    """≙ test_precise_solve_tightens_f32_floor: the envelope reaches the
    swing-up, a lower opt_lag than the plain float32 solve, an opt_constr no
    worse than 1.5× the plain solve's and within 100× of the float64
    solve's (or 1e-9)."""
    plain, env, f64 = solves_t60["plain"], solves_t60["envelope"], solves_t60["f64"]
    np.testing.assert_allclose(float(env.xs[-1, 0]), 3.14, atol=1e-2)
    c_plain, c_env, c_64 = (float(r.stats.opt_constr) for r in (plain, env, f64))
    assert c_env <= c_plain * 1.5, (c_env, c_plain)
    assert float(env.stats.opt_lag) < float(plain.stats.opt_lag)
    assert c_env < 100 * max(c_64, 1e-9), (c_env, c_64)
    assert env.xs.dtype == env.us.dtype == env.mults.val.dtype == env.stats.opt_lag.dtype == F32


def test_storage_mode_closes_f32_floor(solves_t60):
    """≙ test_storage_mode_closes_f32_floor: precise="storage" reaches the
    absolute stationarity target (opt_lag < 1e-8, opt_constr < 1e-10) on the
    T = 60 configuration, results in float32."""
    res = solves_t60["storage"]
    assert precise.supports_storage(make_problem(60, F32))
    np.testing.assert_allclose(float(res.xs[-1, 0]), 3.14, atol=1e-3)
    assert float(res.stats.opt_lag) < 1e-8, float(res.stats.opt_lag)
    assert float(res.stats.opt_constr) < 1e-10, float(res.stats.opt_constr)
    for x in (res.xs, res.us, res.fb_k, res.fb_K, res.mults.val, res.stats.mu, res.stats.step):
        assert x.dtype == F32


def test_storage_mode_requires_tf_support():
    """≙ test_storage_mode_requires_tf_support: UR5 (no double-float hooks in
    ddp_tpu) refuses precise="storage" with a ValueError naming the mode,
    though float64 could store it."""
    arm = robots.ur5(device="cpu", dtype=F32)
    dyn = dynamics.euler(arm, 0.01)
    problem = Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, device="cpu", dtype=F32),
        constraint=constraints.ConfigTarget(model=arm, target=arm.neutral_configuration(), active_ts=(4,)),
        horizon=4, second_order=False,
    )  # fmt: skip
    assert not precise.supports_storage(problem)
    x0 = state_pack(arm.neutral_configuration(), torch.zeros(6))
    with pytest.raises(ValueError, match="storage"):
        solve(problem, SolverParams(2, 1e-5, mu=1e4), x0, precise="storage")
