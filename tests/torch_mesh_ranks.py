"""Gloo process groups for the mesh tests: ``world_of_one`` in the calling
process, and ``spawn_ranks``, which starts ``world`` processes joined
through a ``file://`` store (no TCP port to collide across pytest workers),
runs one function of this module in each and returns what every rank saved.
The ranks import torch and ddp_tpu_torch only (never JAX), and the port's
problems are rebuilt from numpy specs (``problem_from_numpy``)."""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Shard

from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.parallel import mesh as pm
from ddp_tpu_torch.solver import mpc
from ddp_tpu_torch.solver.solve import SolverParams

F64 = dict(device="cpu", dtype=torch.float64)


class world_of_one:
    """A gloo process group of one rank in this process and its batch mesh
    (``with world_of_one() as mesh``), torn down on exit."""

    def __enter__(self):
        self._dir = tempfile.TemporaryDirectory()
        dist.init_process_group("gloo", init_method=f"file://{self._dir.name}/store", rank=0, world_size=1)
        return pm.make_batch_mesh(device_type="cpu")

    def __exit__(self, *exc):
        dist.destroy_process_group()
        self._dir.cleanup()


def _rank_main(rank, world, store, out_dir, task, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = globals()[task](**kw)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_ranks(tmp_path, world, task, **kw) -> list:
    """Run ``task(**kw)`` in ``world`` gloo ranks; each rank's returned dict,
    in rank order.  A failure in any rank raises here."""
    out_dir = tmp_path / f"{task}_{world}"
    out_dir.mkdir()
    mp.spawn(_rank_main, args=(world, str(out_dir / "store"), str(out_dir), task, kw), nprocs=world)
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def mesh_tasks(solve_spec, batched_spec, mpc_spec):
    """The three sharded functions at the anchors' configurations
    (tests/test_aux_subsystems.py), f64, on this rank's block of the mesh:
    ``batch_sharded_solve`` (H = 20, 16 lanes), the same batch handed in as
    a ``Shard(0)`` DTensor, ``batch_sharded_solve_batched`` with
    ``backward="kernel"`` (H = 12, 16 lanes; the kernel's plain version on
    the CPU), three ``make_batch_mpc_step`` replans (H = 20, 16 lanes) with
    the plant stepped on each rank's block, and a batch of 15 lanes, which
    two ranks do not divide."""
    mesh = pm.make_batch_mesh(device_type="cpu")
    r, n = mesh.get_local_rank("batch"), mesh.size()
    out = {"rank": r, "size": n}

    def block(x):  # this rank's rows of a global batch
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]  # fmt: skip

    problem = problem_from_numpy(solve_spec, **F64)
    x0s = torch.tensor([[0.05 * i, 0.0] for i in range(16)], **F64)
    fn = pm.batch_sharded_solve(problem, SolverParams(15, 1e-8, mu=1e6), mesh)
    us, stats = fn(x0s)
    out["solve"] = dict(us=us.to_local(), shape=tuple(us.shape), placements=str(us.placements), **stats)
    us_d, stats_d = fn(DTensor.from_local(block(x0s), mesh, [Shard(0)]))
    out["solve_dtensor_input"] = dict(us=us_d.to_local(), **stats_d)
    try:
        fn(x0s[:15])
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = f"ValueError: {e}"

    problem = problem_from_numpy(batched_spec, **F64)
    x0s = torch.tensor([[0.05 * i, 0.01] for i in range(16)], **F64)
    params = SolverParams(4, 1e-8, mu=1e5, inner_iters_max=1)
    res, stats = pm.batch_sharded_solve_batched(problem, params, mesh, backward="kernel")(x0s)
    out["batched"] = dict(
        us=res.us.to_local(), opt_constr=res.opt_constr.to_local(), mu=res.mu.to_local(),
        mults_val=res.mults.val.to_local(), shape=tuple(res.us.shape), **stats,
    )  # fmt: skip

    problem = problem_from_numpy(mpc_spec, **F64)
    params = SolverParams(3, 1e-6, mu=1e5)
    step = mpc.make_batch_mpc_step(problem, params, mesh)
    x = torch.tensor([[0.03 * i, 0.0] for i in range(16)], **F64)
    carry = mpc.init_batch_carry(problem, 16, torch.float64, x0s=x)
    x_local = block(x)
    u0s, means = [], []
    for _ in range(3):
        u0, carry, mean_c = step(x, carry)
        u0 = u0.to_local()
        # the plant steps each rank's scenarios; the next state goes in sharded
        x_local = problem.dynamics(0, x_local, u0)
        x = DTensor.from_local(x_local, mesh, [Shard(0)])
        u0s.append(u0)
        means.append(mean_c)
    out["mpc"] = dict(u0=torch.stack(u0s), mean_constr=torch.stack(means),
                      mu=carry.mu.to_local(), w=carry.w.to_local())  # fmt: skip
    return out
