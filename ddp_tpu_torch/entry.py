"""Entry points (≙ __graft_entry__.py).

- ``entry()`` → (fn, example_args): the batched constrained pendulum DDP
  solve, ``solve_vmap``, on the card.
- ``dryrun_multichip(n)`` → runs the solve batch sharded over the ranks of
  the existing process group (``parallel/mesh.py``), then the fixed-budget
  production path the same way, then the contract-shape run (B = 4096 at the
  headline's shapes), and returns the row that ``__graft_entry__.py``
  appends to ``benchmarks/results.jsonl``; this writes no file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ddp_tpu_torch.models.pendulum import pendulum
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver.solve import SolverParams, solve_vmap


def _make_problem(horizon, dtype, mu=1e4, device="cuda", second_order=True):
    """The pendulum to q = 3.14 two steps past ``horizon`` (dt = 0.01,
    ½‖u‖², full DDP unless ``second_order`` is False) and its solver
    parameters (12 iterations, 1e-6)."""
    model = pendulum(1.0, 1.0, device=device, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model,
            target=torch.tensor([3.14], dtype=dtype, device=device),
            active_ts=(horizon,),
        ),
        dyn,
        times=2,
    )
    problem = Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, device=device, dtype=dtype),
        constraint=con,
        horizon=horizon,
        second_order=second_order,
    )
    params = SolverParams(max_iterations=12, threshold=1e-6, mu=mu)
    return problem, params


def entry(device="cuda"):
    """(fn, (x0s,)): fn(x0s) is ``solve_vmap``'s controls [8, 32, 1] of the
    full-DDP pendulum from q0 = 0.1·i, float32, on ``device``."""
    dtype = torch.float32
    problem, params = _make_problem(horizon=32, dtype=dtype, device=device)

    def fn(x0s):
        return solve_vmap(problem, params, x0s).us

    batch = 8
    x0s = torch.tensor(np.stack([np.array([0.1 * i, 0.0]) for i in range(batch)]), dtype=dtype, device=device)
    return fn, (x0s,)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """Shard the solve batch over the ``n_devices`` ranks of the existing
    process group (the world size; ``parallel.mesh.multihost_init`` starts
    it) and run it: ``batch_sharded_solve`` on 2 rows a rank (H = 16), the
    fixed-budget ``batch_sharded_solve_batched`` (3 iterations, 2 reg
    levels), and the contract-shape run of the production path (B = 4096,
    H = 32, 8 AL iterations, Gauss-Newton), whose feasible share must pass
    0.99.
    Returns and prints the contract run's row (wall times of the eager
    solve; "first" is the first call, a warm-up, there being no compile)."""
    from ddp_tpu_torch.parallel.mesh import (
        batch_sharded_solve,
        batch_sharded_solve_batched,
        global_mean,
        make_batch_mesh,
        mesh_device,
    )

    mesh = make_batch_mesh(n_devices, device_type)
    device = mesh_device(mesh)
    dtype = torch.float32
    problem, params = _make_problem(horizon=16, dtype=dtype, device=device)
    per_dev = 2
    batch = n_devices * per_dev
    x0s = torch.tensor(np.stack([np.array([0.05 * i, 0.0]) for i in range(batch)]), dtype=dtype, device=device)

    us, stats = batch_sharded_solve(problem, params, mesh)(x0s)
    _sync(device)
    _check(tuple(us.shape) == (batch, problem.horizon, problem.nu), f"us shape {tuple(us.shape)}")
    _check(bool(torch.isfinite(us.to_local()).all()), "non-finite us")
    _check(bool(torch.isfinite(stats["mean_constr"])), "non-finite mean_constr")

    # also the fixed-budget production path (solver/batched.py) on the same
    # mesh: static control flow, a multi-level reg ladder
    bparams = SolverParams(max_iterations=3, threshold=1e-6, mu=1e4, inner_iters_max=1)
    bres, bstats = batch_sharded_solve_batched(problem, bparams, mesh, n_reg_levels=2)(x0s)
    _sync(device)
    _check(tuple(bres.us.shape) == (batch, problem.horizon, problem.nu), f"us shape {tuple(bres.us.shape)}")
    _check(bool(torch.isfinite(bres.us.to_local()).all()), "non-finite us (solve_batched)")
    _check(bool(torch.isfinite(bstats["mean_constr"])), "non-finite mean_constr (solve_batched)")

    # the contract-shape run: B = 4096 over the mesh at the headline's
    # shapes (T = 32, 8 AL iterations, Gauss-Newton)
    problem_c, _ = _make_problem(horizon=32, dtype=dtype, device=device, second_order=False)
    cparams = SolverParams(max_iterations=8, threshold=1e-6, mu=1e4, inner_iters_max=1)
    B = 4096
    rng = np.random.default_rng(0)
    x0s_c = torch.tensor(np.stack([rng.uniform(-0.3, 0.3, B), np.zeros(B)], axis=1), dtype=dtype, device=device)
    cfn = batch_sharded_solve_batched(problem_c, cparams, mesh, n_reg_levels=1)
    t0 = time.perf_counter()
    cres, _ = cfn(x0s_c)
    _sync(device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    cres, _ = cfn(x0s_c)
    _sync(device)
    t_exec = time.perf_counter() - t0
    _check(tuple(cres.us.shape) == (B, problem_c.horizon, problem_c.nu), f"us shape {tuple(cres.us.shape)}")
    _check(bool(torch.isfinite(cres.us.to_local()).all()), "non-finite us (contract run)")
    local = cres.opt_constr.to_local()
    frac = float(global_mean((local < 1e-2).to(local.dtype), mesh))
    _check(frac > 0.99, f"contract run feasible share {frac}")  # the fleet solves, sharded
    row = {
        "metric": "multichip_contract_shape",
        "t": time.strftime("%Y-%m-%d %H:%M:%S"),
        "n_devices": n_devices,
        "B": B,
        "T": problem_c.horizon,
        "iters": 8,
        "frac_feasible_1e-2": round(frac, 4),
        "wall_s_per_step": round(t_exec, 3),
        "wall_s_first_incl_compile": round(t_first, 3),
        "platform": device.type,
        "note": "eager torch.distributed correctness artifact, not a perf claim",
    }
    print("contract-shape sharded run:", row)
    return row
