#!/usr/bin/env python3
"""Where the time of a UR5 MPC replan goes, on one CUDA card.

    python3 examples/torch_mpc_profile.py

Builds chip_smoke.py's UR5 replan (bench.py's: B = 1, T = 16, 3 AL
iterations, f32), warms the carry up over 5 replans from x0 at rest, then
times each layer of one outer iteration on the last replan's warm start
(host clock around a call ending in torch.cuda.synchronize(), median of 5)
and traces one whole replan per route (backward="sweep", the default, and
backward="kernel") with torch.profiler for the device's busy share and
kernel count.  Prints one line per layer; needs a card.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.solver import al, batched, mpc  # noqa: E402


def wall_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    problem = cs.ur5_problem(torch.float32)
    x0 = cs.state_pack(problem.model.neutral_configuration(), torch.zeros(6, device=cs.DEV))
    steps = {b: mpc.make_mpc_step(problem, cs.MPC, backward=b) for b in ("sweep", "kernel")}
    carry = mpc.init_carry(problem)
    for _ in range(5):
        carry = steps["sweep"](x0, carry).carry

    # the state an iteration of the next replan works on: its warm start
    us = carry.us_warm[None]
    xs = problem.rollout(x0[None], us)
    mults = al.update_origin(problem.model, al.AffineMults(*(a[None] for a in carry.mults)), xs)
    mu, reg = carry.mu.clamp(min=cs.MPC.mu)[None], carry.reg[None]
    derivs = problem.derivatives(xs, us)
    k, K, _, _ = batched._backward_multi_reg(derivs, mults.val, mults.jac, mu, reg, 4)
    fb = al.AffineMults(k, K, xs[:, :-1])
    n = cs.MPC.max_iterations
    layers = {
        f"derivatives deriv=jvp ({n + 2})": lambda: problem.derivatives(xs, us),
        f"backward sweep, 4 levels ({n + 1}, default route)": lambda: (
            batched._backward_multi_reg(derivs, mults.val, mults.jac, mu, reg, 4)
        ),
        f"backward kernel, 4 levels in one launch ({n + 1}, kernel route)": lambda: (
            batched._backward_kernel_levels(derivs, mults.val, mults.jac, mu, reg, 4)
        ),
        f"line search sweep, 8 candidates ({n + 1})": lambda: (
            batched._linesearch_sweep(problem, xs, us, k, K, mults, mu, 8)
        ),
        "  (one feedback rollout)": lambda: batched.feedback_rollout(problem, xs, us, k, K, 1.0),
        "  (one AL cost)": lambda: al.al_costs(problem, xs, us, mults, mu),
        f"update_origin x2 ({n}, and 1 after the loop)": lambda: (
            al.update_origin(problem.model, mults, xs), al.update_origin(problem.model, fb, xs)
        ),
        f"optimality obj + lag + constr ({n})": lambda: (
            al.optimality_obj(problem, derivs, mults.val, mults.jac, mu),
            al.optimality_lag(problem, derivs, mults.val, mults.jac),
            al.optimality_constr(derivs),
        ),
        "whole replan, sweep route": lambda: steps["sweep"](x0, carry),
        "whole replan, kernel route": lambda: steps["kernel"](x0, carry),
    }
    for name, fn in layers.items():
        print(f"[layer] {name}: {wall_ms(fn):.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    for route, step in steps.items():
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(x0, carry)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        count = sum(e.count for e in events if e.self_device_time_total > 0)
        print(f"[profile] route={route} wall_ms={wall:.1f} device_busy_ms={busy:.3f} "
              f"device_idle_share={1 - busy / wall:.4f} device_events={count}", flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
