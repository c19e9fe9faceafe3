#!/usr/bin/env python3
"""Kernel #4 (the fused line search) and path A of the pendulum headline on
one CUDA card, for the port in the tree at ``--root`` (default: this
checkout), so that two trees can be timed in turns in one call:

    python3 examples/torch_linesearch_ab.py [--root DIR] [--label NAME] [--horizons T ...]

At the headline shape (T=32, B=4096, 4 candidates, float32, chip_smoke.py's
numpy-seeded line-search state; the inputs and timers are this checkout's
chip_smoke.py) it prints one line: the card's name and power limit; the
kernel on checked inputs two ways, CUDA events around one launch (median of
50 after a warm-up; the host's submission of the launch counts, as in
chip_smoke.py's ``ms``) and its device time with 50 launches queued behind a
sleep kernel (``chip_smoke.device_ms``; the submission does not count); the
wrapper's whole call as path A makes it; the same in float64; the kernel's
launch plan where the tree reports one; with ``--horizons`` the float32
kernel's device time at each of those T; and path A's solves/s
(``solve_batched(forward="kernel", backward="kernel")`` on bench.py's
headline, host clock to ``torch.cuda.synchronize()``, median of 5 after a
warm-up).  It reads either wrapper API: ``plan_launch``/``launch_plan``, or
the earlier ``pack_batch_last``/``linesearch_packed``.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--horizons", type=int, nargs="*", default=[],
                    help="also the float32 kernel's device time at these T (same B)")  # fmt: skip
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    # this checkout's chip_smoke.py (its inputs and timers) over the port at --root
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import ddp_tpu_torch
    from ddp_tpu_torch.kernels import linesearch_flat as lsf

    assert Path(ddp_tpu_torch.__file__).resolve().parent.parent == root
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    n_ls = cs.HEADLINE_KW["n_linesearch"]

    def kernel_and_call(dtype, Tk=cs.T):
        problem, s = cs.linesearch_inputs(cs.B, dtype, Tk=Tk)
        if hasattr(lsf, "plan_launch"):
            flat = lsf.pack_problem(problem)
            plan = lsf.plan_launch(problem, *s, n_ls, flat=flat)
            launch = lambda: lsf.launch_plan(plan)  # noqa: E731
            call = cs.event_ms(lambda: lsf.linesearch(problem, *s, n_ls, flat=flat), reps=50)
            geometry = plan.geometry
        else:
            flat, packed = lsf.pack_batch_last(problem, *s)
            launch = lambda: lsf.linesearch_packed(flat, packed, n_ls)  # noqa: E731
            call = cs.event_ms(lambda: lsf.linesearch(problem, *s, n_ls), reps=50)
            geometry = {}
        return cs.event_ms(launch, reps=50), cs.device_ms(launch), call, geometry

    t0 = time.perf_counter()
    if inspect.signature(lsf._kernel_fn).parameters:  # a library per problem class
        lsf._kernel_fn(lsf.pack_problem(cs.linesearch_inputs(cs.B, torch.float32)[0]).build)
    else:
        lsf._kernel_fn()
    build_s = time.perf_counter() - t0
    k32, dev32, call32, plan32 = kernel_and_call(torch.float32)
    k64, dev64, call64, plan64 = kernel_and_call(torch.float64)
    by_T = {Tk: round(kernel_and_call(torch.float32, Tk)[1], 4) for Tk in args.horizons}

    problem = cs.problem_from_numpy(cs.SPEC, device=cs.DEV, dtype=torch.float32)
    x0s = cs.headline_x0s(torch.float32)

    def run_a():
        res = cs.solve_batched(problem, cs.HEADLINE, x0s, backward="kernel", forward="kernel",
                               **cs.HEADLINE_KW)  # fmt: skip
        torch.cuda.synchronize()
        return res

    res = run_a()
    feasible = float((res.opt_constr < 1e-2).float().mean())
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_a()
        walls.append(time.perf_counter() - t0)
    print(
        f"[linesearch_ab] label={args.label} card='{card}' build_s={build_s:.1f} "
        f"kernel_ms={k32:.4f} kernel_device_ms={dev32:.4f} wrapper_call_ms={call32:.4f} "
        f"kernel_f64_ms={k64:.4f} kernel_device_f64_ms={dev64:.4f} "
        f"wrapper_call_f64_ms={call64:.4f} plan_f32={plan32} plan_f64={plan64} "
        f"device_ms_by_T={by_T} path_A_solve_s={[f'{w:.4f}' for w in walls]} "
        f"path_A_solves_per_s={cs.B / statistics.median(walls):.1f} path_A_feasible={feasible}",
        flush=True,
    )


if __name__ == "__main__":
    main()
