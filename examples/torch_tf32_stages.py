#!/usr/bin/env python3
"""Which stage of the 7-DoF fleet solve loses feasible lanes to TF32, on one
CUDA card.

    python3 examples/torch_tf32_stages.py

Runs chip_smoke.py's arm solve (256 panda7 arms, H=16, f32, 24 iterations,
deriv="kernel", backward="kernel", forward="seq") five times on the same
inputs: under matmul_precision="highest"; under "high" (TF32 allowed
everywhere but the stages ``al.full_fp32_matmuls`` pins); under "highest"
with TF32 allowed inside one stage only, the derivative pass or the line
search (its rollouts and AL costs); and under "high" with those two stages
pinned as well, which leaves TF32 in the rest of the iteration (the
multiplier update's products, the first rollout).  Prints per run the
feasible share (max_t |eq_t| < 1e-2), the share of lanes whose μ equals the
"highest" run's and the largest |Δu| against it.  Needs a card.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.solver import al  # noqa: E402
from ddp_tpu_torch.solver import batched  # noqa: E402


@contextlib.contextmanager
def tf32_allowed():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def inside(ctx, fn):
    """``fn`` with every call run inside a fresh ``ctx()``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with ctx():
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def patched(stages, ctx):
    """Run the named stages of ``batched`` inside ``ctx``: "derivatives" (the
    kernel derivative pass) and "linesearch" (``_linesearch_seq``)."""
    saved = batched._kernel_derivatives, batched._linesearch_seq
    if "derivatives" in stages:
        orig = batched._kernel_derivatives
        batched._kernel_derivatives = lambda problem: inside(ctx, orig(problem))
    if "linesearch" in stages:
        batched._linesearch_seq = inside(ctx, batched._linesearch_seq)
    try:
        yield
    finally:
        batched._kernel_derivatives, batched._linesearch_seq = saved


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    problem, x0s, us0 = cs.arm_problem(torch.float32)

    def run(precision, stages=(), ctx=None):
        with patched(stages, ctx) if stages else contextlib.nullcontext():
            res = batched.solve_batched(
                problem, cs.ARM, x0s, us_init=us0, deriv="kernel", backward="kernel",
                **dict(cs.ARM_KW, matmul_precision=precision),
            )  # fmt: skip
        torch.cuda.synchronize()
        return res

    ref = run("highest")
    runs = (
        ("highest", ref),
        ("high", run("high")),
        ("highest, TF32 in derivatives only", run("highest", ("derivatives",), tf32_allowed)),
        ("highest, TF32 in line search only", run("highest", ("linesearch",), tf32_allowed)),
        ("high, derivatives and line search pinned",
         run("high", ("derivatives", "linesearch"), al.full_fp32_matmuls)),
    )  # fmt: skip
    for label, res in runs:
        frac = float((res.opt_constr < 1e-2).float().mean())
        print(f"[tf32_stage] card='{card}' run='{label}' frac_main={frac} "
              f"mu_equal={float((res.mu == ref.mu).float().mean())} "
              f"us_max_diff={float((res.us - ref.us).abs().max()):.3e}", flush=True)  # fmt: skip


if __name__ == "__main__":
    main()
