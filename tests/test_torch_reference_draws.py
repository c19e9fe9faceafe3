"""Where the float-native schedule's decisions are roundoff, in ddp_tpu and
in the port, on the CPU: the test holds that the products of ``solve``'s
single-trajectory sweep round as XLA's do (batched ones at B = 1 do not),
and the script measures what the port's records cite, each too slow for
tier-1:

    JAX_PLATFORMS=cpu python tests/test_torch_reference_draws.py WHAT

- ``quadrotor_share``: ddp_tpu's feasible share for the quadrotor row's
  recipe (bench.py's, B = 256, H = 32, 36 iterations, f32, jit,
  backward="sweep"), the bar chip_smoke.py holds the port to (~2 min);
- ``ur5_share``: ddp_tpu's feasible share after the Gauss-Newton stage of
  benchmarks/arm_second_order.py's UR5 chain (B = 512, H = 16, 8 iterations,
  f32, jit, deriv="jvp", backward="sweep"), the bar chip_smoke.py holds the
  port's UR5 chain to (~2 min);
- ``double_pendulum_share``: ddp_tpu's feasible share for BASELINE
  configs[2], benchmarks/double_pendulum_reach.py's recipe (B = 2048,
  H = 32, 12 iterations, f32, jit, n_linesearch=8, forward="seq",
  matmul_precision="high") through deriv="jvp", backward="sweep" (the
  recipe's "pallas" backends run on the CPU only in interpret mode), the bar
  chip_smoke.py phase 15c holds the port's kernel route to;
- ``arm_lanes``: the arm fleet of examples/torch_arm_lanes.py at a seed
  (default 3) through jvp/sweep in both packages: feasible shares and the
  lanes whose opt_lag is not finite (~3 min);
- ``golden_draws``: the golden configuration from x0 = 0 and five
  perturbations of 1e-15 and 1e-13 in both packages: iterations and
  convergence within 200 (~20 min, most of it the port's stalled runs);
- ``jit_vs_eager``: ddp_tpu's tests/test_history.py solve jitted and op by op
  (jax.disable_jit): the rows where their gate outcomes and accepted steps
  part (~6 min);
- ``assoc_share``: ddp_tpu's feasible share through ``backward="assoc"`` on
  bench.py's headline (B = 4096, T = 32, 8 iterations, f32, jit,
  n_reg_levels=1, n_linesearch=4) and on its T200 row (the same at H = 200,
  forward="seq"), and how many lanes its assoc and sweep routes leave within
  1e-3 of their largest |u| of its Pallas route: the bars chip_smoke.py
  phase 12 holds the port's routes to (~2 min; last run: share 1.0 at
  T = 32 in 10.2 s and at T = 200 in 30.2 s, p99 ‖eq‖ 1.380e-4 and
  7.773e-4; lanes agreeing with Pallas 1.0 for both routes at T = 32,
  0.971435546875 (assoc) and 0.968994140625 (sweep) at T = 200);
- ``tf_share``: ddp_tpu's feasible share on the headline through
  ``backward="tf", precise_cost=True``, the bar of chip_smoke.py phase 12's
  tf route (last run: 1.0, p99 1.380e-4, 10.8 s);
- ``precise_draws``: tests/test_precise.py's T = 60 solve, plain, envelope
  and storage, from x0 = 0, five axis perturbations and 16 seeded ones in
  both packages: (opt_lag, μ) of each and how often the anchors' opt_lag
  bars hold, the bars of chip_smoke.py phase 12d (~5 min; last run:
  ddp_tpu's envelope below its plain solve from 9 of 22 starts, its storage
  mode below 1e-8 from 14; the port's from 6 and 16);
- ``storage_gains``: the storage solve from the same starts in ddp_tpu and
  in four variants of the port, which shows where rounding the gains to
  float32 matters (~5 min; last run, opt_lag < 1e-8 from: ddp_tpu 14, the
  port 16, K rounded only in the multiplier increment 0, only in the line
  search 16, rounded and summed in float32 as ddp_tpu sums 9).
- ``examples``: the recipes of examples/pendulum_swingup.py (f32 and f64),
  examples/ur5_reach.py (f64) and examples/mpc_fleet.py (one device,
  B = 512) in ddp_tpu, at full precision: the constants chip_smoke.py
  phase 14c holds the port's examples to (~1.5 min).  The fleet's recipe
  runs ``backward="sweep"``, the Pallas sweep's XLA counterpart: the
  example's ``backward="pallas"`` runs on the CPU only in interpret mode,
  which its ``make_batch_mpc_step`` does not take.
"""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch_parity_helpers import jax_pendulum_problem, torch_problem  # noqa: E402


def test_two_dim_products_round_as_xla_batched_ones_do_not():
    """AᵀVA and Aᵀv of 2×2 blocks (the pendulum's sweep): as 2-D products
    the port's CPU bits are XLA's in every draw; as batched products at
    B = 1 most draws differ, which is why ``solve`` runs its sweep and
    adjoints without a batch dim."""
    rng = np.random.default_rng(0)
    chain = jax.jit(lambda A, V: A.T @ V @ A)
    draws, batched_differs = 200, 0
    for _ in range(draws):
        A, V = rng.standard_normal((2, 2)), rng.standard_normal((2, 2))
        ref = np.asarray(chain(A, V))
        tA, tV = torch.from_numpy(A), torch.from_numpy(V)
        np.testing.assert_array_equal((tA.mT @ tV @ tA).numpy(), ref)
        batched_differs += bool(((tA[None].mT @ tV[None] @ tA[None])[0].numpy() != ref).any())
    assert batched_differs > draws // 2, batched_differs


# ---------------------------------------------------------------- the script


def quadrotor_share():
    from ddp_tpu.models import base
    from ddp_tpu.models.robots import quadrotor
    from ddp_tpu.ocp import constraints, costs, dynamics
    from ddp_tpu.ocp.problem import Problem
    from ddp_tpu.solver.batched import solve_batched
    from ddp_tpu.solver.solve import SolverParams

    dtype, B, H = jnp.float32, 256, 32
    quad = quadrotor(dtype=dtype)
    dyn = dynamics.euler(quad, 0.02)
    q0 = quad.neutral_configuration()
    q_goal = quad.integrate(q0, jnp.asarray([0.3, -0.2, 0.4, 0.0, 0.0, 0.2], dtype))
    con = constraints.advance_time(
        constraints.StateTarget(model=quad, target=base.state_pack(q_goal, jnp.zeros(6, dtype)),
                                active_ts=(H,)),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype), constraint=con,
                      horizon=H, second_order=False)  # fmt: skip
    params = SolverParams(max_iterations=36, threshold=1e-5, mu=1e4, inner_iters_max=3)
    rng = np.random.default_rng(0)
    x0 = base.state_pack(q0, jnp.zeros(6, dtype))
    dxs = 0.05 * rng.standard_normal((B, 12)).astype(np.float32)
    x0s = jax.vmap(lambda d: base.state_integrate(quad, x0, d))(jnp.asarray(dxs, dtype))
    zero_v = jnp.zeros(6, dtype)
    grav = jax.vmap(lambda x: quad.rnea(x[:7], zero_v, zero_v))(x0s)
    us0 = jnp.tile(grav[:, None, :], (1, H, 1))
    r = jax.jit(lambda x, u: solve_batched(problem, params, x, us_init=u, backward="sweep",
                                           matmul_precision="highest", n_linesearch=8,
                                           forward="seq"))(x0s, us0)  # fmt: skip
    oc = np.asarray(r.opt_constr)
    qn = np.linalg.norm(np.asarray(r.xs[:, -1, 3:7], np.float64), axis=1)
    print(f"ddp_tpu quadrotor row: feasible share {float(np.mean(oc < 1e-2))}, p99 "
          f"{float(np.percentile(oc, 99)):.3e}, quaternion norm max error "
          f"{float(np.abs(qn - 1).max()):.3e}")  # fmt: skip


def ur5_share():
    from ddp_tpu.models import base
    from ddp_tpu.models.robots import ur5
    from ddp_tpu.ocp import constraints, costs, dynamics
    from ddp_tpu.ocp.problem import Problem
    from ddp_tpu.solver.batched import solve_batched
    from ddp_tpu.solver.solve import SolverParams

    dtype, B, H = jnp.float32, 512, 16
    arm = ur5(dtype=dtype)
    dyn = dynamics.euler(arm, 0.01)
    q0 = arm.neutral_configuration()
    q_target = arm.integrate(q0, jnp.asarray(0.05 * np.arange(1.0, 7.0), dtype))
    con = constraints.advance_time(
        constraints.ConfigTarget(model=arm, target=q_target, active_ts=(H,)), dyn, times=2
    )
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype), constraint=con,
                      horizon=H, second_order=False)  # fmt: skip
    params = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    x0 = base.state_pack(q0, jnp.zeros(arm.nv, dtype))
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.asarray(x0)[None] + 0.1 * rng.standard_normal((B, 2 * arm.nv)), dtype)
    t0 = time.perf_counter()
    r = jax.jit(lambda x: solve_batched(problem, params, x, backward="sweep", deriv="jvp",
                                        matmul_precision="high", n_linesearch=4,
                                        forward="seq"))(x0s)  # fmt: skip
    oc = np.asarray(r.opt_constr)
    print(f"ddp_tpu UR5 Gauss-Newton stage: feasible share {float(np.mean(oc < 1e-2))}, p99 "
          f"{float(np.percentile(oc, 99)):.3e}, finite us {bool(np.isfinite(np.asarray(r.us)).all())}, "
          f"{time.perf_counter() - t0:.1f} s")  # fmt: skip


def double_pendulum_share():
    from ddp_tpu.models.rigid_body import double_pendulum
    from ddp_tpu.ocp import constraints, costs, dynamics
    from ddp_tpu.ocp.problem import Problem
    from ddp_tpu.solver.batched import solve_batched
    from ddp_tpu.solver.solve import SolverParams

    dtype, B, H = jnp.float32, 2048, 32
    model = double_pendulum(dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(model=model, target=jnp.asarray([0.8, -0.5], dtype), active_ts=(H,)),
        dyn, times=2,
    )  # fmt: skip
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype), constraint=con,
                      horizon=H, second_order=False)  # fmt: skip
    params = SolverParams(max_iterations=12, threshold=1e-5, mu=1e4, inner_iters_max=1)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.concatenate([rng.uniform(-0.3, 0.3, (B, 2)), 0.2 * rng.standard_normal((B, 2))], axis=1),
        dtype,
    )
    t0 = time.perf_counter()
    r = jax.jit(lambda x: solve_batched(problem, params, x, backward="sweep", deriv="jvp",
                                        matmul_precision="high", n_linesearch=8,
                                        forward="seq"))(x0s)  # fmt: skip
    oc = np.asarray(r.opt_constr)
    print(f"ddp_tpu double pendulum (configs[2]): feasible share {float(np.mean(oc < 1e-2))}, p99 "
          f"{float(np.percentile(oc, 99)):.3e}, finite us {bool(np.isfinite(np.asarray(r.us)).all())}, "
          f"{time.perf_counter() - t0:.1f} s")  # fmt: skip


def arm_lanes(seed=3):
    from ddp_tpu.models.robots import panda7
    from ddp_tpu.solver.batched import solve_batched as jsolve_batched
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu_torch.solver.batched import solve_batched
    from ddp_tpu_torch.solver.solve import SolverParams
    from torch_parity_helpers import PANDA_READY, jax_arm_problem

    B, H = 256, 16
    jp = jax_arm_problem(panda7(dtype=jnp.float32), "ee", PANDA_READY, H)
    tp = torch_problem(jp, np.float32)
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([np.asarray(PANDA_READY), np.zeros(7)])
    x0s = (x0[None] + 0.05 * rng.standard_normal((B, 14))).astype(np.float32)
    zero_v = torch.zeros(7)
    us0 = tp.model.rnea(torch.tensor(x0s[:, :7]), zero_v, zero_v)[:, None, :].repeat(1, H, 1)
    kw = dict(max_iterations=24, threshold=1e-5, mu=1e4, inner_iters_max=1)
    ls = dict(n_linesearch=2, forward="seq", matmul_precision="highest")
    rt = solve_batched(tp, SolverParams(**kw), torch.tensor(x0s), us_init=us0, deriv="jvp",
                       backward="sweep", **ls)  # fmt: skip
    rj = jax.jit(lambda x, u: jsolve_batched(jp, JParams(**kw), x, us_init=u, backward="sweep", **ls))(
        jnp.asarray(x0s), jnp.asarray(us0.numpy())
    )
    for name, lag, mu, oc, val in (
        ("ddp_tpu_torch", rt.opt_lag.numpy(), rt.mu.numpy(), rt.opt_constr.numpy(), rt.mults.val.numpy()),
        ("ddp_tpu", *(np.asarray(a) for a in (rj.opt_lag, rj.mu, rj.opt_constr, rj.mults.val))),
    ):  # fmt: skip
        bad = np.nonzero(~np.isfinite(lag))[0]
        print(f"{name} seed {seed}: feasible share {float(np.mean(oc < 1e-2))}; lanes with a "
              f"non-finite opt_lag {bad.tolist()} (opt_lag {lag[bad].tolist()}, mu "
              f"{mu[bad].tolist()}, largest multiplier "
              f"{[float(np.abs(val[b]).max()) for b in bad]})")  # fmt: skip


def golden_draws():
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu.solver.solve import solve as jsolve
    from ddp_tpu_torch import SolverParams, solve

    jp = jax_pendulum_problem(200, jnp.float64, second_order=True)
    tp = torch_problem(jp)
    kw = dict(max_iterations=200, threshold=1e-9, mu=1e8)
    run = jax.jit(lambda x: jsolve(jp, JParams(**kw), x))
    for x0 in ([0.0, 0.0], [1e-15, 0.0], [0.0, 1e-15], [-1e-15, 0.0], [1e-13, 0.0], [0.0, -1e-13]):
        rj = run(jnp.asarray(x0))
        rt = solve(tp, SolverParams(**kw), torch.tensor(x0, dtype=torch.float64))
        print(f"x0 {x0}: ddp_tpu {int(rj.stats.iterations)} iterations, converged "
              f"{bool(rj.stats.converged)}; ddp_tpu_torch {int(rt.stats.iterations)}, converged "
              f"{bool(rt.stats.converged)}", flush=True)  # fmt: skip


def jit_vs_eager():
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu.solver.solve import solve as jsolve

    jp = jax_pendulum_problem(100, jnp.float64, second_order=True)
    params = JParams(max_iterations=40, threshold=1e-9, mu=1e6)
    rj = jax.jit(lambda x: jsolve(jp, params, x, history=True))(jnp.zeros(2))
    t0 = time.perf_counter()
    with jax.disable_jit():
        re = jsolve(jp, params, jnp.zeros(2), history=True)
    print(f"op by op: {time.perf_counter() - t0:.0f} s")

    def gates(h):
        return "".join("S" if s else "F" if f else "."
                       for s, f in zip(np.asarray(h.upd_success), np.asarray(h.upd_failure)))  # fmt: skip

    gj, ge = gates(rj.history), gates(re.history)
    steps = np.asarray(rj.history.step) == np.asarray(re.history.step)
    first = next((i for i, (a, b) in enumerate(zip(gj, ge)) if a != b), None)
    print(f"jitted   {gj}\nop by op {ge}\nfirst row whose gate differs: {first}; first row whose "
          f"accepted step differs: {int(np.argmin(steps)) if not steps.all() else None}")  # fmt: skip


def _headline_share(H, **kw):
    """ddp_tpu's feasible share (opt_constr < 1e-2) and p99 ‖eq‖ for bench.py's
    headline recipe at horizon ``H`` (B = 4096, f32, jit) with ``kw``; returns
    the result."""
    from ddp_tpu.solver.batched import solve_batched
    from ddp_tpu.solver.solve import SolverParams

    B = 4096
    jp = jax_pendulum_problem(H, jnp.float32)
    params = SolverParams(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1), jnp.float32)
    t0 = time.perf_counter()
    r = jax.jit(lambda x: solve_batched(jp, params, x, n_reg_levels=1, n_linesearch=4, **kw))(x0s)
    oc = np.asarray(r.opt_constr)
    print(f"ddp_tpu H={H} {kw}: feasible share {float(np.mean(oc < 1e-2))}, p99 "
          f"{float(np.percentile(oc, 99)):.3e}, finite us {bool(np.isfinite(np.asarray(r.us)).all())}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)  # fmt: skip
    return r


def _lane_agreement(a, b):
    """chip_smoke.py's bar: the share of lanes whose us agree within 1e-3 of
    the lane's largest |u| (at least 1), the worst scaled difference and the
    share of lanes with the same μ."""
    ua, ub = np.asarray(a.us), np.asarray(b.us)
    diff = np.abs(ua - ub).max(axis=(1, 2))
    scale = np.maximum(np.abs(ub).max(axis=(1, 2)), 1.0)
    return (float(np.mean(diff <= 1e-3 * scale)), float((diff / scale).max()),
            float(np.mean(np.asarray(a.mu) == np.asarray(b.mu))))  # fmt: skip


def assoc_share():
    """Also the lane agreement of ddp_tpu's own routes at each horizon: assoc
    and sweep against the Pallas backward (interpret mode)."""
    for H, kw in ((32, {}), (200, dict(forward="seq"))):
        r = {b: _headline_share(H, backward=b, **kw) for b in ("assoc", "sweep")}
        r["pallas"] = _headline_share(H, backward="pallas", interpret=True, **kw)
        for b in ("assoc", "sweep"):
            print(f"ddp_tpu H={H}: {b} against pallas: lanes agreeing, worst scaled difference, "
                  f"same μ {_lane_agreement(r[b], r['pallas'])}", flush=True)  # fmt: skip


def tf_share():
    _headline_share(32, backward="tf", precise_cost=True)


def precise_starts():
    """x0 = 0, five axis perturbations and 16 seeded ones (the starts of
    chip_smoke.py phase 12d), float32."""
    rng = np.random.default_rng(1)
    axis = ([0.0, 0.0], [1e-6, 0.0], [0.0, 1e-6], [-1e-6, 0.0], [1e-5, 0.0], [0.0, -1e-5])
    seeded = [s * rng.standard_normal(2) for s in (1e-6, 1e-5) for _ in range(8)]
    return [np.asarray(x, np.float32) for x in (*axis, *seeded)]


def precise_draws():
    """tests/test_precise.py's T = 60 configuration (f32, mu 1e6, 40
    iterations; threshold 1e-7, storage 1e-9) from ``precise_starts()`` in
    both packages: the plain solve, the envelope and the storage mode,
    (opt_lag, final μ) of each, and how often the anchors' opt_lag bars
    hold."""
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu.solver.solve import solve as jsolve
    from ddp_tpu_torch import SolverParams, solve

    jp = jax_pendulum_problem(60, jnp.float32)
    tp = torch_problem(jp, np.float32)
    modes = ((False, 1e-7), (True, 1e-7), ("storage", 1e-9))
    jfns = [jax.jit(lambda x, m=m, th=th: jsolve(jp, JParams(40, th, mu=1e6), x, precise=m)) for m, th in modes]
    runs = dict(
        ddp_tpu=lambda i, x0: jfns[i](jnp.asarray(x0)).stats,
        ddp_tpu_torch=lambda i, x0: solve(tp, SolverParams(40, modes[i][1], mu=1e6), torch.from_numpy(x0),
                                          precise=modes[i][0]).stats,
    )  # fmt: skip
    met = {name: [0, 0] for name in runs}
    for x0 in precise_starts():
        for name, run in runs.items():
            plain, env, sto = (run(i, x0) for i in range(3))
            met[name][0] += float(env.opt_lag) < float(plain.opt_lag)
            met[name][1] += float(sto.opt_lag) < 1e-8 and float(sto.opt_constr) < 1e-10
            print(f"x0 {x0.tolist()} {name}: (opt_lag, mu) plain ({float(plain.opt_lag):.3e}, {float(plain.mu):.0e}) "
                  f"envelope ({float(env.opt_lag):.3e}, {float(env.mu):.0e}) storage ({float(sto.opt_lag):.3e}, "
                  f"{float(sto.mu):.0e}, opt_constr {float(sto.opt_constr):.1e})", flush=True)  # fmt: skip
    for name, (env_below, sto_met) in met.items():
        print(f"{name}: envelope below plain from {env_below}, storage below 1e-8 from {sto_met} "
              f"of {len(precise_starts())} starts")  # fmt: skip


def storage_gains():
    """Where rounding the feedback gains to float32 (as ddp_tpu's storage
    mode does) matters: tests/test_precise.py's T = 60 storage solve from
    ``precise_starts()`` in ddp_tpu and in four variants of the port, how
    often opt_lag < 1e-8: as shipped (gains float64); K rounded only in the
    multiplier increment eq_x + eq_u·K summed in float64; K rounded only in
    the line search; k and K rounded and the increments summed in float32 on
    the float32 iterate, as ddp_tpu sums them."""
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu.solver.solve import solve as jsolve
    from ddp_tpu_torch import SolverParams, solve
    from ddp_tpu_torch.solver import al as al_mod
    from ddp_tpu_torch.solver import precise

    F32, F64 = torch.float32, torch.float64
    jp = jax_pendulum_problem(60, jnp.float32)
    tp = torch_problem(jp, np.float32)
    jf = jax.jit(lambda x: jsolve(jp, JParams(40, 1e-9, mu=1e6), x, precise="storage"))
    base = precise.Storage

    def round_gains(r):
        return r._replace(k=r.k.to(F32).to(F64), K=r.K.to(F32).to(F64))

    class IncrementK(base):
        def increments(self, derivs, fb, xs, feedback):
            return super().increments(derivs, fb._replace(jac=fb.jac.to(F32).to(F64)), xs, feedback)

    class LineSearchK(base):
        def forward(self, xs, us, k, K, mults, mu):
            return super().forward(xs, us, k, K.to(F32).to(F64), mults, mu)

    class AsDdpTpu(base):
        def backward(self, derivs, mults, mu, reg):
            return round_gains(super().backward(derivs, mults, mu, reg))

        def increments(self, derivs, fb, xs, feedback):
            fbm = al_mod.update_origin(self.problem.model, al_mod.AffineMults(*(f.to(F32) for f in fb)),
                                       xs.to(F32))  # fmt: skip
            equ = derivs.equ.to(F32)
            fb_term = torch.einsum("tou,tu->to", equ, fbm.val)
            fb_term_jac = torch.einsum("tou,tuj->toj", equ, fbm.jac)
            return derivs.eq + fb_term.to(F64), (derivs.eqx.to(F32) + fb_term_jac).to(F64)

    def port(stages):
        def run(x0):
            precise.Storage = stages
            try:
                return solve(tp, SolverParams(40, 1e-9, mu=1e6), torch.from_numpy(x0), precise="storage").stats
            finally:
                precise.Storage = base

        return run

    runs = dict(ddp_tpu=lambda x0: jf(jnp.asarray(x0)).stats, port=port(base), increment_K=port(IncrementK),
                line_search_K=port(LineSearchK), as_ddp_tpu=port(AsDdpTpu))  # fmt: skip
    met = dict.fromkeys(runs, 0)
    for x0 in precise_starts():
        lags = {name: float(run(x0).opt_lag) for name, run in runs.items()}
        for name, lag in lags.items():
            met[name] += lag < 1e-8
        print(f"x0 {x0.tolist()}: opt_lag {', '.join(f'{n} {v:.3e}' for n, v in lags.items())}", flush=True)
    print(f"opt_lag < 1e-8 from, of {len(precise_starts())} starts: {met}")


def examples():
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ddp_tpu import Method
    from ddp_tpu.models import base
    from ddp_tpu.models.robots import ee_frame_id, ur5
    from ddp_tpu.ocp import constraints, costs, dynamics
    from ddp_tpu.ocp.problem import Problem
    from ddp_tpu.parallel.mesh import make_batch_mesh
    from ddp_tpu.solver.mpc import init_batch_carry, make_batch_mpc_step
    from ddp_tpu.solver.solve import SolverParams as JParams
    from ddp_tpu.solver.solve import solve as jsolve

    for dtype in (jnp.float32, jnp.float64):  # examples/pendulum_swingup.py
        problem = jax_pendulum_problem(200, dtype, second_order=True)
        params = JParams(max_iterations=60, threshold=1e-8, mu=1e8 if dtype == jnp.float64 else 1e4)
        r = jax.jit(lambda x: jsolve(problem, params, x, method=Method.PRIMAL_DUAL_AFFINE))(jnp.zeros(2, dtype))
        print(f"pendulum_swingup {jnp.dtype(dtype).name}: converged {bool(r.stats.converged)}, "
              f"iterations {int(r.stats.iterations)}, final q {float(r.xs[-1, 0])!r}, "
              f"|eq| {float(r.stats.opt_constr)!r}", flush=True)  # fmt: skip

    arm = ur5(dtype=jnp.float64)  # examples/ur5_reach.py
    H = 12
    dyn = dynamics.euler(arm, 0.01)
    fid = ee_frame_id(arm)
    q0 = arm.neutral_configuration()
    p_target = arm.frame_position(fid, arm.integrate(q0, jnp.asarray([0.2, -0.15, 0.1, 0.05, -0.1, 0.08])))
    con = constraints.advance_time(
        constraints.FrameTarget(model=arm, target=p_target, frame_id=fid, active_ts=(H,)), dyn, times=2
    )
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, dtype=jnp.float64), constraint=con,
                      horizon=H, second_order=False)  # fmt: skip
    params = JParams(max_iterations=55, threshold=1e-8, mu=1e8)
    r = jax.jit(lambda x: jsolve(problem, params, x))(base.state_pack(q0, jnp.zeros(arm.nv)))
    print(f"ur5_reach: target {np.asarray(p_target).tolist()}, reached "
          f"{np.asarray(arm.frame_position(fid, r.xs[-1, : arm.nq])).tolist()}, |eq| "
          f"{float(r.stats.opt_constr)!r}, iterations {int(r.stats.iterations)}", flush=True)  # fmt: skip

    H, B = 24, 512  # examples/mpc_fleet.py on one device
    problem = jax_pendulum_problem(H, jnp.float32)
    params = JParams(max_iterations=6, threshold=1e-4, mu=1e4)
    mesh = make_batch_mesh(1)
    step = make_batch_mpc_step(problem, params, mesh, backward="sweep")
    sh = NamedSharding(mesh, P("batch"))
    rng = np.random.default_rng(0)
    x = jax.device_put(jnp.asarray(np.stack([rng.uniform(-0.5, 0.5, B), np.zeros(B)], 1), jnp.float32), sh)
    carry = init_batch_carry(problem, B, jnp.float32, x0s=jnp.asarray(np.asarray(x)))
    carry = jax.device_put(carry, jax.tree.map(lambda _: sh, carry))
    u0, carry, mc = step(x, carry)
    for _ in range(20):
        u0, carry, mc = step(x, carry)
        x = x.at[:, 0].add(0.01 * x[:, 1])
    for _ in range(20):
        u0, carry, mc = step(x, carry)
    print(f"mpc_fleet B={B}: mean |eq| after 41 replans {float(mc)!r}, finite u0 "
          f"{bool(np.isfinite(np.asarray(u0)).all())}")  # fmt: skip


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    jobs = dict(quadrotor_share=quadrotor_share, ur5_share=ur5_share,
                double_pendulum_share=double_pendulum_share, arm_lanes=arm_lanes, golden_draws=golden_draws,
                jit_vs_eager=jit_vs_eager, assoc_share=assoc_share, tf_share=tf_share,
                precise_draws=precise_draws, storage_gains=storage_gains, examples=examples)  # fmt: skip
    if what not in jobs:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(jobs)}}} [seed]")
    jobs[what](*map(int, sys.argv[2:]))
