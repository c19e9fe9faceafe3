#!/usr/bin/env python3
"""Where the time of ddp_tpu_torch's 7-DoF fleet solve goes, on one CUDA card.

    python3 examples/torch_arm_profile.py [--second-order]

Builds chip_smoke.py's arm problem (256 panda7 arms, H=16, f32), runs one
solve with deriv="kernel", backward="kernel", forward="seq", then times each
layer of one outer iteration on the finished solve's trajectory (host clock
around a call ending in torch.cuda.synchronize(), median of 5) and traces
one whole solve with torch.profiler for the device's busy share and kernel
count.  With ``--second-order`` the layers and the trace are those of the
full-DDP polish stage (chip_smoke.py's phase 6: 4 iterations on the
second_order problem, warm-started on the Gauss-Newton solve).  Prints one
line per layer; needs a card.
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
from ddp_tpu_torch.solver import al  # noqa: E402
from ddp_tpu_torch.solver import batched  # noqa: E402


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
    second = "--second-order" in sys.argv[1:]
    problem, x0s, us0 = cs.arm_problem(torch.float32)
    res = cs.arm_solve(problem, x0s, us0, "kernel", "kernel")
    xs, us, mults, mu, reg = res.xs, res.us, res.mults, res.mu, res.reg
    iters = cs.DDP.max_iterations if second else cs.ARM.max_iterations
    candidates = cs.DDP_KW["n_linesearch"] if second else cs.ARM_KW["n_linesearch"]
    if second:
        problem, _, _ = cs.arm_problem(torch.float32, second_order=True)

        def whole():
            return cs.ddp_stage(problem, x0s, res, "kernel", "kernel")

    else:

        def whole():
            return cs.arm_solve(problem, x0s, us0, "kernel", "kernel")

    kernel_derivs = batched._kernel_derivatives(problem)
    derivs = kernel_derivs(xs, us)

    def backward_kernel():
        return batched._backward_kernel_levels(
            derivs, mults.val, mults.jac, mu, reg, 4, second_order=second
        )

    k, K, _, _ = backward_kernel()
    fb = al.AffineMults(k, K, xs[:, :-1])
    layers = {
        f"derivatives deriv=kernel ({iters + 2})": lambda: kernel_derivs(xs, us),
        "  (derivatives deriv=jvp)": lambda: problem.derivatives(xs, us),
        f"backward kernel, 4 levels incl. packing ({iters + 1})": backward_kernel,
        "  (backward sweep, 4 levels)": lambda: (
            batched._backward_multi_reg(derivs, mults.val, mults.jac, mu, reg, 4)
        ),
        f"line search seq, {candidates} candidates ({iters + 1})": lambda: (
            batched._linesearch_seq(problem, xs, us, k, K, mults, mu, candidates)
        ),
        "  (one feedback rollout)": lambda: batched.feedback_rollout(problem, xs, us, k, K, 1.0),
        "  (one AL cost)": lambda: al.al_costs(problem, xs, us, mults, mu),
        f"update_origin x2 ({iters})": lambda: (
            al.update_origin(problem.model, mults, xs), al.update_origin(problem.model, fb, xs)
        ),
        f"optimality obj + lag + constr ({iters})": lambda: (
            al.optimality_obj(problem, derivs, mults.val, mults.jac, mu),
            al.optimality_lag(problem, derivs, mults.val, mults.jac),
            al.optimality_constr(derivs),
        ),
        "whole solve": whole,
    }
    if second:
        layers = {
            "  (packing the second-order slabs alone)": lambda: cs.rs.pack_batch_last(
                derivs, mults.val, mults.jac, second_order=True
            ),
            **layers,
        }
    for name, fn in layers.items():
        print(f"[layer] {name}: {wall_ms(fn, 3 if name == 'whole solve' else 5):.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        whole()
    wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    count = sum(e.count for e in events if e.self_device_time_total > 0)
    print(f"[profile] wall_ms={wall:.1f} device_busy_ms={busy:.3f} "
          f"device_idle_share={1 - busy / wall:.4f} device_events={count}", flush=True)  # fmt: skip
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[profile] {e.key[:70]} self_device_ms={e.self_device_time_total / 1e3:.3f} "
              f"count={e.count}", flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
