"""Faults planted in the timed path, and the control, for the tests and the
calibration of the check's limits.  Each is ``program(route, call)`` for
``run.run_cell``: it wraps the route's timed call."""

from __future__ import annotations

import torch

from perfbench.reference import flat_al_ddp


def control(cfg: dict, dtype=torch.bfloat16):
    """The plain reference put in the program's place, computed in the
    precision below the configuration's (bfloat16 for float32; the solve has
    no matrix product for TF32 to touch).  With ``dtype`` the configuration's
    own type it is the witness of what that type's rounding alone does."""

    def wrap(route, call):
        def solve(x0s):
            out = flat_al_ddp.solve(cfg, x0s, dtype)
            return {k: v.to(x0s.dtype) for k, v in out.items()}

        return solve

    return wrap


def unchanged(cfg: dict):
    """A solve that returns the state it started from: zero controls and
    gains, their rollout, zero multipliers, the schedule's first values."""
    r = flat_al_ddp.Recipe(cfg)

    def wrap(route, call):
        def solve(x0s):
            B, T, kw = x0s.shape[0], r.T, dict(dtype=x0s.dtype, device=x0s.device)
            us = torch.zeros((B, T, 1), **kw)
            xs = flat_al_ddp.rollout(r, x0s, us)
            eq = flat_al_ddp.constraint(r, xs[:, r.ta], us[:, r.ta])
            return dict(
                us=us, xs=xs, fb_k=torch.zeros_like(us), fb_K=torch.zeros((B, T, 1, 2), **kw),
                mult_val=torch.zeros((B, T, r.e), **kw), mult_jac=torch.zeros((B, T, r.e, 2), **kw),
                mult_origin=xs[:, :T], opt_constr=torch.linalg.vector_norm(eq, dim=-1),
                opt_lag=torch.zeros(B, **kw), mu=torch.full((B,), r.mu0, **kw),
                reg=torch.full((B,), r.reg0, **kw), w=torch.full((B,), r.w0, **kw),
                n=torch.full((B,), r.n0, **kw),
            )  # fmt: skip

        return solve

    return wrap


def half(cfg: dict):
    """Half of the batch left out: the program solves the first half, and
    its results stand for the second half too."""

    def wrap(route, call):
        def solve(x0s):
            f = route.fields(call(x0s[: x0s.shape[0] // 2]))
            return {k: torch.cat([v, v]) for k, v in f.items()}

        return solve

    return wrap


def altered(cfg: dict):
    """One answer altered where it is produced: one lane's control at one
    step moved by 0.05·max(1, |u|) in every call."""

    def wrap(route, call):
        def solve(x0s):
            f = dict(route.fields(call(x0s)))
            us = f["us"].clone()
            lane, t = x0s.shape[0] // 3, us.shape[1] // 2
            us[lane, t] += 0.05 * torch.clamp(us[lane, t].abs(), min=1.0)
            f["us"] = us
            return f

        return solve

    return wrap


FAULTS = dict(unchanged=unchanged, half=half, altered=altered)
