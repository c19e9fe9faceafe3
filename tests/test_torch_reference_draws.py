"""Where the float-native schedule's decisions are roundoff, in ddp_tpu and
in the port, on the CPU: the test holds that the products of ``solve``'s
single-trajectory sweep round as XLA's do (batched ones at B = 1 do not),
and the script measures what the port's records cite, each too slow for
tier-1:

    JAX_PLATFORMS=cpu python tests/test_torch_reference_draws.py WHAT

- ``quadrotor_share``: ddp_tpu's feasible share for the quadrotor row's
  recipe (bench.py's, B = 256, H = 32, 36 iterations, f32, jit,
  backward="sweep"), the bar chip_smoke.py holds the port to (~2 min);
- ``arm_lanes``: the arm fleet of examples/torch_arm_lanes.py at a seed
  (default 3) through jvp/sweep in both packages: feasible shares and the
  lanes whose opt_lag is not finite (~3 min);
- ``golden_draws``: the golden configuration from x0 = 0 and five
  perturbations of 1e-15 and 1e-13 in both packages: iterations and
  convergence within 200 (~20 min, most of it the port's stalled runs);
- ``jit_vs_eager``: ddp_tpu's tests/test_history.py solve jitted and op by op
  (jax.disable_jit): the rows where their gate outcomes and accepted steps
  part (~6 min).
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


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    jobs = dict(quadrotor_share=quadrotor_share, arm_lanes=arm_lanes, golden_draws=golden_draws,
                jit_vs_eager=jit_vs_eager)  # fmt: skip
    if what not in jobs:
        sys.exit(f"usage: {sys.argv[0]} {{{','.join(jobs)}}} [seed]")
    jobs[what](*map(int, sys.argv[2:]))
