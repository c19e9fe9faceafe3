#!/usr/bin/env python3
"""The arm fleet's feasible share and its lanes of largest μ over several
seeds, on one CUDA card: chip_smoke.py's 7-DoF fleet (256 panda7 arms, H=16,
24 AL iterations, f32) solved with deriv="kernel", with deriv="jvp" /
backward="sweep" and with the fd kernel's plain version on the card in the
kernel's place.

    python3 examples/torch_arm_lanes.py [--seeds 0 1 2 3]

Seed 0 is chip_smoke.py's fleet; another seed draws the fleet's start states
x0s = (q_ready, 0) + 0.05·N(0, 1) from ``default_rng(seed)``.  Prints for each
seed and solve the feasible share, the lanes whose opt_lag is not finite with
their μ, opt_constr, opt_lag (inf or NaN), largest multiplier and largest
feedforward gain, and the six lanes of largest μ with their largest
multiplier and opt_lag.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ddp_tpu_torch.kernels import fd_derivs as fd  # noqa: E402
from ddp_tpu_torch.solver import batched  # noqa: E402


def fleet(seed):
    """chip_smoke.py's f32 arm problem with start states from ``seed`` (its
    own at seed 0)."""
    problem, _, _ = cs.arm_problem(torch.float32)
    arm = problem.model
    rng = np.random.default_rng(seed)
    x0 = cs.state_pack(torch.tensor(cs.ARM_READY), torch.zeros(arm.nv)).numpy()
    x0s = torch.tensor(x0[None] + 0.05 * rng.standard_normal((cs.ARM_B, problem.nx)),
                       dtype=torch.float32, device=cs.DEV)  # fmt: skip
    zero_v = torch.zeros(arm.nv, dtype=torch.float32, device=cs.DEV)
    us0 = arm.rnea(x0s[:, : arm.nq], zero_v, zero_v)[:, None, :].repeat(1, cs.ARM_H, 1)
    return problem, x0s, us0


def report(seed, tag, r):
    bad = ~torch.isfinite(r.opt_lag)
    top = torch.argsort(r.mu, descending=True)[:6]
    print(f"[arm_lanes] seed={seed} solve={tag} frac_main={float((r.opt_constr < 1e-2).float().mean())} "
          f"nonfinite_opt_lag_lanes={torch.nonzero(bad).flatten().tolist()} "
          f"their_mu={r.mu[bad].tolist()} their_opt_constr={r.opt_constr[bad].tolist()} "
          f"their_opt_lag={r.opt_lag[bad].tolist()} "
          f"their_mult_max={r.mults.val[bad].abs().flatten(1).amax(1).tolist()} "
          f"their_fb_k_max={r.fb_k[bad].abs().flatten(1).amax(1).tolist()} "
          f"top_mu_lanes={top.tolist()} top_mu={r.mu[top].tolist()} "
          f"top_mult_max={r.mults.val[top].abs().amax(dim=(1, 2)).tolist()} "
          f"top_opt_lag={r.opt_lag[top].tolist()}", flush=True)  # fmt: skip


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    kernel_fd = batched.fd_derivs
    for seed in args.seeds:
        p, x, u = fleet(seed)
        batched.fd_derivs = kernel_fd
        report(seed, "kernel", cs.arm_solve(p, x, u, "kernel", "kernel"))
        report(seed, "jvp_sweep", cs.arm_solve(p, x, u, "jvp", "sweep"))
        batched.fd_derivs = fd.fd_derivs_reference  # the plain version, on the card
        report(seed, "fd_plain_version", cs.arm_solve(p, x, u, "kernel", "kernel"))
    batched.fd_derivs = kernel_fd


if __name__ == "__main__":
    main()
