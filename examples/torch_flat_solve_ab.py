#!/usr/bin/env python3
"""Kernel #5 (the one-launch whole solve) on one CUDA card, for the port in
the tree at ``--root`` (default: this checkout), so that two trees can be
timed in turns in one call:

    python3 examples/torch_flat_solve_ab.py [--root DIR] [--label NAME]

At four shapes, B = 4096 lanes, 4 candidates, float32, from bench.py's
headline starts (q ~ U(-π, π), the inputs and timers of this checkout's
chip_smoke.py): the headline (T = 32, 8 iterations), the arrive-at-rest
state class at T = 32 (8 iterations), the arrive-at-rest fleet (T = 100, 30
iterations) and bench.py's T200 row (T = 200, 8 iterations).  For each it
prints one line: the card's name and power limit; the kernel on a launch plan
two ways, CUDA events around one launch (median after a warm-up; the host's
submission counts, as in chip_smoke.py's ``ms``) and its device time with
launches queued behind a sleep kernel (``chip_smoke.device_ms``; the
submission does not count); the plain version's time (one call, host clock
to a synchronize); the feasible share of the result; and the launch plan:
threads a lane, lanes a block, shared-memory bytes a block and, where the
tree's wrapper reports them, the program, blocks an SM, lanes an SM and
waves (otherwise blocks an SM and waves are computed from the shared memory
and threads alone, ``smem_waves``).  Both trees' wrappers take
``plan_launch``/``launch_plan``.  Where the tree's wrapper can be told the
program (``plan_launch(..., _program=...)``), it then times each shape in
the program its plan did not pick, and the fleet's class at B = 1024, where
both programs run in one wave and the plan takes the resident one on the
tie, in both (``program_ab`` lines: events and device time, the plan).
Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
SMS, SM_SMEM, SM_THREADS = 132, 233472, 2048  # one H100 SXM SM: bytes (1 KB a block reserved), threads


def smem_waves(geometry, B):
    """Blocks an SM and waves of a plan from its shared memory and threads
    alone (for a tree whose wrapper does not report them)."""
    lpb, threads = geometry["lanes_per_block"], geometry["lanes_per_block"] * geometry["threads_per_lane"]
    per_sm = min(SM_SMEM // (geometry["smem_bytes"] + 1024), SM_THREADS // threads, 32)
    blocks = -(-B // lpb)
    return dict(blocks_per_sm=per_sm, lanes_per_sm=per_sm * lpb, waves=-(-blocks // (SMS * per_sm)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="tree")
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
    from ddp_tpu_torch.kernels import flat_solve as fs

    assert Path(ddp_tpu_torch.__file__).resolve().parent.parent == root
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    f32, n_ls = torch.float32, cs.HEADLINE_KW["n_linesearch"]
    shapes = {
        "headline_T32_I8": (cs.flat_class_spec("headline", cs.T), cs.HEADLINE),
        "state_T32_I8": (cs.flat_class_spec("state", cs.T), cs.HEADLINE),
        f"fleet_T{cs.STATE_T}_I{cs.STATE.max_iterations}": (cs.flat_class_spec("state", cs.STATE_T), cs.STATE),
        f"t200_T{cs.T200}_I8": (cs.flat_class_spec("headline", cs.T200), cs.HEADLINE),
    }
    problems = {k: cs.problem_from_numpy(s, device=cs.DEV, dtype=f32) for k, (s, _) in shapes.items()}
    builds = []
    for p in problems.values():
        if (build := cs.pack_problem(p).build) not in builds:
            builds.append(build)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(fs._kernel_fn, builds))
    build_s = time.perf_counter() - t0
    x0s = cs.headline_x0s(f32)
    picked = {}
    for name, (_, params) in shapes.items():
        plan = fs.plan_launch(problems[name], params, x0s, n_linesearch=n_ls)
        res = fs.launch_plan(plan)
        torch.cuda.synchronize()
        feasible = float((res.opt_constr < 1e-2).float().mean())
        long_ = params.max_iterations > 8 or name.startswith("t200")
        ms = cs.event_ms(lambda: fs.launch_plan(plan), reps=5 if long_ else 20)
        dev = cs.device_ms(lambda: fs.launch_plan(plan), n=10 if long_ else 50)
        t0 = time.perf_counter()
        fs.solve_flat_reference(problems[name], params, x0s, n_linesearch=n_ls)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        geometry = dict(plan.geometry)
        picked[name] = geometry.get("program")
        if "waves" not in geometry:
            geometry.update(smem_waves=smem_waves(geometry, cs.B))
        print(
            f"[flat_solve_ab] label={args.label} card='{card}' shape={name} B={cs.B} C={n_ls} "
            f"build_s={build_s:.1f} kernel_ms={ms:.4f} kernel_device_ms={dev:.4f} plain_ms={plain_ms:.1f} "
            f"feasible={feasible} plan={geometry}",
            flush=True,
        )
    if "_program" not in inspect.signature(fs.plan_launch).parameters:
        return
    other = {"resident": "streamed", "streamed": "resident"}
    cases = [(name, cs.B, other[picked[name]]) for name in shapes]
    tie = f"fleet_T{cs.STATE_T}_I{cs.STATE.max_iterations}"
    cases += [(tie, 1024, "resident"), (tie, 1024, "streamed")]
    for name, Bk, program in cases:
        params = shapes[name][1]
        try:
            plan = fs.plan_launch(problems[name], params, x0s[:Bk], n_linesearch=n_ls, _program=program)
        except ValueError as exc:  # no lane of this program fits
            print(f"[program_ab] label={args.label} shape={name} B={Bk} program={program} refused='{exc}'")
            continue
        long_ = params.max_iterations > 8 or name.startswith("t200")
        ms = cs.event_ms(lambda: fs.launch_plan(plan), reps=5 if long_ else 20)
        dev = cs.device_ms(lambda: fs.launch_plan(plan), n=10 if long_ else 50)
        print(
            f"[program_ab] label={args.label} card='{card}' shape={name} B={Bk} C={n_ls} program={program} "
            f"kernel_ms={ms:.4f} kernel_device_ms={dev:.4f} plan={plan.geometry}",
            flush=True,
        )


if __name__ == "__main__":
    main()
