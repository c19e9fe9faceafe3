"""Faults planted in the timed path, and the control, for the tests and the
calibration of the check's limits.  Each takes the plain reference that
the cell's route names (a module of ``reference/``, its interface in
``reference/compare.py``) and the configuration, and gives
``program(route, call)`` for ``run.run_cell``: it wraps the route's timed
call, whose input may be any pytree of batch-first tensors."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map


def control(ref, cfg: dict, dtype=torch.bfloat16):
    """The plain reference put in the program's place, computed in the
    precision below the configuration's (bfloat16 for float32; the solve has
    no matrix product for TF32 to touch).  With ``dtype`` the configuration's
    own type it is the witness of what that type's rounding alone does."""

    def wrap(route, call):
        def solve(given):
            out = ref.solve(cfg, given, dtype)
            return {k: v.to(route.dtype) for k, v in out.items()}

        return solve

    return wrap


def unchanged(ref, cfg: dict):
    """A solve that returns the state it started from: the program's result
    replaced by zero controls and gains, their rollout, zero multipliers and
    the schedule's first values."""
    r = ref.Recipe(cfg)

    def wrap(route, call):
        def solve(given):
            f = route.fields(call(given))
            us = torch.zeros_like(f["us"])
            xs = ref.rollout(r, given, us)
            B, T = us.shape[:2]

            def full(value):
                return torch.full((B,), value, dtype=us.dtype, device=us.device)

            return dict(
                us=us, xs=xs, fb_k=torch.zeros_like(us), fb_K=torch.zeros_like(f["fb_K"]),
                mult_val=torch.zeros_like(f["mult_val"]), mult_jac=torch.zeros_like(f["mult_jac"]),
                mult_origin=xs[:, :T], opt_constr=torch.linalg.vector_norm(ref.final_eq(r, xs, us), dim=-1),
                opt_lag=full(0.0), mu=full(r.mu0), reg=full(r.reg0), w=full(r.w0), n=full(r.n0),
            )  # fmt: skip

        return solve

    return wrap


def half(ref, cfg: dict):
    """Half of the batch left out: the program solves the first half, and
    its results stand for the second half too."""

    def wrap(route, call):
        def solve(given):
            n = tree_leaves(given)[0].shape[0] // 2
            f = route.fields(call(tree_map(lambda v: v[:n], given)))
            return {k: torch.cat([v, v]) for k, v in f.items()}

        return solve

    return wrap


def altered(ref, cfg: dict):
    """One answer altered where it is produced: one lane's control at one
    step moved by 0.05·max(1, |u|) in every call."""

    def wrap(route, call):
        def solve(given):
            f = dict(route.fields(call(given)))
            us = f["us"].clone()
            lane, t = us.shape[0] // 3, us.shape[1] // 2
            us[lane, t] += 0.05 * torch.clamp(us[lane, t].abs(), min=1.0)
            f["us"] = us
            return f

        return solve

    return wrap


FAULTS = dict(unchanged=unchanged, half=half, altered=altered)
