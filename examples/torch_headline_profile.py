#!/usr/bin/env python3
"""Where the time of ddp_tpu_torch's pendulum headline goes, by route, on one
CUDA card.

    python3 examples/torch_headline_profile.py

Builds chip_smoke.py's headline problem (4096 constrained pendulum swing-ups,
T=32, f32, 8 AL iterations), times each layer of one outer iteration on a
finished solve's trajectory (host clock around a call ending in
torch.cuda.synchronize(), median of 5), then for each route of the whole
solve — backward="sweep", backward="kernel", path A (forward="kernel",
backward="kernel") and path B (kernels.flat_solve.solve_flat) — the wall time
(median of 5) and a torch.profiler trace of one solve: the device's busy time
and idle share, the count of device kernels, and the device time of the
port's own kernels by name.  Prints one line per layer and route; needs a
card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.solver import al  # noqa: E402
from ddp_tpu_torch.solver import batched  # noqa: E402
from torch_arm_profile import wall_ms  # noqa: E402

OWN_KERNELS = ("riccati_bwd_kernel", "linesearch_flat_kernel", "flat_solve_kernel")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    problem = cs.problem_from_numpy(cs.SPEC, device=cs.DEV, dtype=torch.float32)
    x0s = cs.headline_x0s(torch.float32)
    kw, n_ls = cs.HEADLINE_KW, cs.HEADLINE_KW["n_linesearch"]
    iters = cs.HEADLINE.max_iterations

    routes = {
        "backward=sweep": lambda: cs.solve_batched(problem, cs.HEADLINE, x0s, backward="sweep", **kw),
        "backward=kernel": lambda: cs.solve_batched(problem, cs.HEADLINE, x0s, backward="kernel", **kw),
        "path A: forward=kernel backward=kernel": lambda: cs.solve_batched(
            problem, cs.HEADLINE, x0s, backward="kernel", forward="kernel", **kw
        ),
        "path B: solve_flat": lambda: cs.fs.solve_flat(problem, cs.HEADLINE, x0s, n_linesearch=n_ls),
    }  # fmt: skip
    res = routes["backward=kernel"]()
    xs, us, mults, mu, reg = res.xs, res.us, res.mults, res.mu, res.reg
    derivs = problem.derivatives(xs, us)
    k, K, _, _ = batched._backward_kernel_levels(derivs, mults.val, mults.jac, mu, reg, 1)
    fb = al.AffineMults(k, K, xs[:, :-1])
    layers = {
        f"derivatives ({iters + 2})": lambda: problem.derivatives(xs, us),
        f"backward kernel incl. packing ({iters + 1})": lambda: (
            batched._backward_kernel_levels(derivs, mults.val, mults.jac, mu, reg, 1)
        ),
        "  (backward sweep)": lambda: (
            batched._backward_multi_reg(derivs, mults.val, mults.jac, mu, reg, 1)
        ),
        f"line search sweep, {n_ls} candidates ({iters + 1})": lambda: (
            batched._linesearch_sweep(problem, xs, us, k, K, mults, mu, n_ls)
        ),
        f"  line search kernel incl. packing ({iters + 1} on path A)": lambda: (
            batched._linesearch_kernel(problem, xs, us, k, K, mults, mu, n_ls)
        ),
        f"update_origin x2 ({iters})": lambda: (
            al.update_origin(problem.model, mults, xs), al.update_origin(problem.model, fb, xs)
        ),
        f"optimality obj + lag + constr ({iters})": lambda: (
            al.optimality_obj(problem, derivs, mults.val, mults.jac, mu),
            al.optimality_lag(problem, derivs, mults.val, mults.jac),
            al.optimality_constr(derivs),
        ),
    }
    for name, fn in layers.items():
        print(f"[layer] {name}: {wall_ms(fn):.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    for name, fn in routes.items():
        ms = wall_ms(fn)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0)
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        own = {
            key: f"{sum(e.self_device_time_total for e in events if key in e.key) / 1e3:.3f}"
            for key in OWN_KERNELS
            if any(key in e.key for e in events)
        }
        print(f"[route] {name}: wall_ms={ms:.3f} solves_per_s={cs.B / ms * 1e3:.1f} "
              f"traced_wall_ms={traced:.1f} device_busy_ms={busy:.3f} "
              f"device_idle_share_of_traced={1 - busy / traced:.4f} "
              f"device_idle_share_of_untraced_wall={max(0.0, 1 - busy / ms):.4f} "
              f"device_kernels={sum(e.count for e in events)} own_kernels_ms={own}", flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
