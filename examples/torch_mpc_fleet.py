#!/usr/bin/env python3
"""Scenario-fleet MPC: batched replanning sharded over a device mesh, on
ddp_tpu_torch (≙ examples/mpc_fleet.py, BASELINE configs[5]'s pattern scaled
to the ranks present).

The pendulum to q = 3.14 two steps past H = 24, Gauss-Newton,
``SolverParams(6, 1e-4, mu=1e4)``, 512 scenarios a rank from x0 ~ U(-0.5,
0.5) (``default_rng(0)``), replanned through ``make_batch_mpc_step`` and the
Riccati kernel (``backward="kernel"``) with the multipliers warm-started:
20 blocking replans (each waited for, the stand-in plant stepped between
them), then 20 back to back.

    python3 examples/torch_mpc_fleet.py [--device cuda|cpu] [--dtype float32|float64]
    torchrun --nproc-per-node=N examples/torch_mpc_fleet.py   # N cards

A world of one process starts its own process group (NCCL on the card, gloo
on the host); under torchrun ``multihost_init`` joins the ranks.  Prints
what examples/mpc_fleet.py prints, then, in place of its row in
benchmarks/results.jsonl, one JSON line of the same fields with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ddp_tpu_torch import SolverParams  # noqa: E402
from ddp_tpu_torch.models.pendulum import pendulum  # noqa: E402
from ddp_tpu_torch.ocp import constraints, costs, dynamics  # noqa: E402
from ddp_tpu_torch.ocp.problem import Problem  # noqa: E402
from ddp_tpu_torch.parallel.mesh import make_batch_mesh, mesh_device, multihost_init  # noqa: E402
from ddp_tpu_torch.solver.mpc import init_batch_carry, make_batch_mpc_step  # noqa: E402

H, PER_RANK, REPLANS = 24, 512, 20
BACKWARD = "kernel"


def build(device="cuda", dtype=torch.float32, n_scenarios=PER_RANK, horizon=H):
    """The recipe: (problem, params, x [n_scenarios, 2]).  Raises on
    ``device="cuda"`` without a card."""
    kw = dict(device=device, dtype=dtype)
    model = pendulum(1.0, 1.0, **kw)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(model, torch.tensor([3.14], **kw), active_ts=(horizon,)), dyn, times=2
    )
    problem = Problem(dynamics=dyn, cost=costs.quad_control(1.0, **kw), constraint=con,
                      horizon=horizon, second_order=False)  # fmt: skip
    # 6 iterations converge the fleet within a few replans
    params = SolverParams(max_iterations=6, threshold=1e-4, mu=1e4)
    rng = np.random.default_rng(0)
    x = np.stack([rng.uniform(-0.5, 0.5, n_scenarios), np.zeros(n_scenarios)], 1)
    return problem, params, torch.tensor(x, **kw)


def plant_step(x):
    """The stand-in plant: q += 0.01·v."""
    return torch.stack([x[:, 0] + 0.01 * x[:, 1], x[:, 1]], dim=1)


def card():
    """nvidia-smi's name and power limit of the card, or None."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]  # fmt: skip


def run(mesh, dtype=torch.float32, per_rank=PER_RANK, n_replans=REPLANS):
    """The fleet on ``mesh``: a first replan, ``n_replans`` blocking and
    ``n_replans`` back to back.  Returns B, the mesh's size, the seconds a
    replan of each protocol, the last mean |eq|, this rank's last u0 and the
    number of replans run."""
    device = mesh_device(mesh)
    B = mesh.size() * per_rank
    problem, params, x = build(device, dtype, B)
    step = make_batch_mpc_step(problem, params, mesh, backward=BACKWARD)
    carry = init_batch_carry(problem, B, dtype, x0s=x)

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    u0, carry, mc = step(x, carry)  # the first replan (warm-up)
    wait()
    # blocking: wait for u0 each replan (a real plant in the loop)
    t0 = time.perf_counter()
    for _ in range(n_replans):
        u0, carry, mc = step(x, carry)
        x = plant_step(x)
        wait()
    s_blocking = (time.perf_counter() - t0) / n_replans
    # back to back: keep the device's queue full
    t0 = time.perf_counter()
    for _ in range(n_replans):
        u0, carry, mc = step(x, carry)
    wait()
    s_sustained = (time.perf_counter() - t0) / n_replans
    return dict(B=B, n_devices=mesh.size(), iters=params.max_iterations, s_blocking=s_blocking,
                s_sustained=s_sustained, mean_constr=float(mc), u0=u0.to_local(),
                replans=1 + 2 * n_replans)  # fmt: skip


def main(device="cuda", dtype=torch.float32, per_rank=PER_RANK, n_replans=REPLANS):
    """Run the fleet on every rank of the process group (started here for a
    world of one process) and print examples/mpc_fleet.py's line and row on
    rank 0; returns ``run``'s dict with the row under ``"row"``."""
    multihost_init()
    own = None
    if not dist.is_initialized():
        own = tempfile.TemporaryDirectory()
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{own.name}/store", rank=0, world_size=1)
    try:
        out = run(make_batch_mesh(device_type=torch.device(device).type), dtype, per_rank, n_replans)
        rank = dist.get_rank()
    finally:
        if own is not None:
            dist.destroy_process_group()
            own.cleanup()
    B, dt_block, dt_sust = out["B"], out["s_blocking"], out["s_sustained"]
    out["row"] = dict(
        metric="fleet_replan", t=time.strftime("%Y-%m-%d %H:%M:%S"), B=B, n_devices=out["n_devices"], H=H,
        iters=out["iters"], backend=BACKWARD, warm_mults=True, ms_blocking=round(dt_block * 1e3, 2),
        ms_sustained=round(dt_sust * 1e3, 2), mean_constr=f"{out['mean_constr']:.2e}", card=card(),
    )  # fmt: skip
    if rank == 0:
        print(
            f"{B} scenarios on {out['n_devices']} device(s): "
            f"{dt_block * 1e3:.2f} ms/replan blocking ({B / dt_block:.0f} scenario-replans/s), "
            f"{dt_sust * 1e3:.2f} ms/replan sustained ({B / dt_sust:.0f}/s), "
            f"mean |eq| = {out['mean_constr']:.2e}"
        )
        print(json.dumps(out["row"]), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    a = ap.parse_args()
    main(a.device, getattr(torch, a.dtype))
