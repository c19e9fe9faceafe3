"""The comparison that decides ``correct``: the program's results of the
compared calls against the plain reference solved again from the same
inputs in float64, and against the reference's own dynamics and constraint
applied to the program's trajectories.

The reference is the module ``perfbench/reference/<REFERENCE>.py`` that the
cell's route names; the harness loads it and hands it in, so a configuration
brings its own as a new file.  A call's input is whatever the traffic gave
the call: a pytree of batch-first tensors (a start batch; a state and a
carry), the compared calls' inputs joined leaf by leaf.  A reference module
gives:

- ``TYPES``: the configurations' ``dtype`` names → torch dtypes;
- ``Recipe(cfg)``: the numbers of a configuration, with ``w_min`` and
  ``threshold`` (the floors of w and n) and ``mu0``, ``reg0``, ``w0``,
  ``n0`` (the schedule's first values, which a solve that leaves its state
  unchanged reports);
- ``solve(cfg, inputs, dtype)``: every lane of ``inputs`` solved in
  ``dtype``, the 13 fields of the program's result by name, batch-major:
  us, xs, fb_k, fb_K, mult_val, mult_jac, mult_origin, and per lane
  opt_constr, opt_lag, mu, reg, w, n;
- ``starts(inputs)``: each lane's start state, x0s [B, nx];
- ``dynamics(r, xs, us)``: the next states of states xs [..., nx] under
  controls us [..., nu];
- ``rollout(r, inputs, us)``: xs [B, T + 1, nx] of the controls us
  [B, T, nu] from the inputs' starts;
- ``final_eq(r, xs, us)``: each lane's constraint vector [B, e] on its whole
  trajectory (xs [B, T + 1, nx], us [B, T, nu]).

Each compared lane gets a gap per field: the largest difference from the
reference, as a share of the field's scale (for arrays the larger of the
lane's largest reference entry and the median lane's; for opt_constr and
opt_lag the larger of the reference's value and the feasibility limit; for
μ the reference's value; for reg the larger of the reference's reg and μ;
for w and n the larger of the reference's value and the floor the schedule
holds them to, w_min and the threshold).  The fields fall in two groups:

- ``SOLUTION``: the trajectory, the feedback gains, the multipliers'
  Jacobians, μ and reg, which the recipe decides;
- ``SENSITIVE``: the feedforward gains, the multipliers' values, the two
  stationarity measures, w and n.  At a large μ (1e7, say) float32's
  rounding of the constraint's value (~2e-7 at |q| ≈ 3) moves a multiplier
  by ~2 an update, so these are set by rounding, in the float32 reference
  as much as in the program: they are held by their median lane.

The numbers compared, each with a limit of its own from the cell's
workload file:

- ``lanes_apart``: the share of compared lanes whose ``SOLUTION`` gap
  exceeds ``LANE_TOL``, whose feasibility (opt_constr below the limit)
  differs from the reference's, or whose result is not finite;
- ``gap_median``: the median lane's ``SOLUTION`` gap;
- ``sensitive_median``: the median lane's ``SENSITIVE`` gap;
- ``rollout_residual``: over every compared lane and step, how far the
  program's xs[t + 1] lies from the reference's dynamics at the program's
  (xs[t], us[t]), and xs[0] from the start, as a share of the lane's largest
  |x|;
- ``constr_residual``: over every compared lane, how far the reported
  opt_constr lies from the reference's ‖eq‖ at the program's final
  trajectory.
"""

from __future__ import annotations

import math

import torch
from torch.utils._pytree import tree_map

LANE_TOL = 1e-2
SOLUTION = ("us", "xs", "mult_origin", "fb_K", "mult_jac", "mu", "reg")
SENSITIVE = ("fb_k", "mult_val", "opt_constr", "opt_lag", "w", "n")
NUMBERS = ("lanes_apart", "gap_median", "sensitive_median", "rollout_residual", "constr_residual")
BLOCK = 1 << 16  # lanes the reference solves at once, so that it fits beside the results
_ARRAYS = ("us", "xs", "mult_origin", "fb_K", "mult_jac", "fb_k", "mult_val")


def _ratio(d, s):
    """d / s with 0 / 0 = 0 and d / 0 = inf (d, s ≥ 0)."""
    return torch.where(s > 0, d / torch.where(s > 0, s, torch.ones_like(s)),
                       torch.where(d > 0, torch.full_like(d, math.inf), torch.zeros_like(d)))  # fmt: skip


def _diff(g, r):
    d = (g.to(r.dtype) - r).abs()
    return torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))


def field_gaps(reference, cfg: dict, got: dict, ref: dict) -> dict:
    """Per field, each lane's gap [B] (non-finite entries give inf)."""
    rec = reference.Recipe(cfg)
    out = {}
    for name in _ARRAYS:
        r = ref[name].flatten(1)
        if r.shape[1] == 0:
            continue
        d = _diff(got[name].flatten(1), r).amax(1)
        s = r.abs().amax(1)
        out[name] = _ratio(d, torch.maximum(s, s.median()))
    floors = dict(opt_constr=float(cfg["feasible_below"]), opt_lag=float(cfg["feasible_below"]),
                  w=rec.w_min, n=rec.threshold, mu=0.0)  # fmt: skip
    for name, floor in floors.items():
        r = ref[name]
        out[name] = _ratio(_diff(got[name], r), torch.clamp(r.abs(), min=floor))
    out["reg"] = _ratio(_diff(got["reg"], ref["reg"]), torch.maximum(ref["reg"].abs(), ref["mu"].abs()))
    return out


def residuals(reference, cfg: dict, x0s, got: dict):
    """(rollout_residual, constr_residual) of the program's own trajectories
    from the starts x0s [B, nx] under the reference's dynamics and
    constraint, in float64."""
    r = reference.Recipe(cfg)
    xs = got["xs"].to(torch.float64)
    us = got["us"].to(torch.float64)
    x0 = x0s.to(torch.float64)
    scale = torch.clamp(xs.abs().flatten(1).amax(1), min=1.0)
    step = (xs[:, 1:] - reference.dynamics(r, xs[:, :-1], us)).abs().amax((1, 2))
    start = (xs[:, 0] - x0).abs().amax(1)
    roll = torch.maximum(step, start) / scale
    oc = torch.linalg.vector_norm(reference.final_eq(r, xs, us), dim=-1)
    con = (got["opt_constr"].to(torch.float64) - oc).abs()

    def worst(v):
        v = torch.where(torch.isfinite(v), v, torch.full_like(v, math.inf))
        return float(v.max())

    return worst(roll), worst(con)


def judge(reference, cfg: dict, inputs, got: dict) -> tuple[dict, dict]:
    """The numbers of ``NUMBERS`` for the program's results ``got`` (fields
    batch-major, a lane per lane of ``inputs``) and, per field, the share of
    lanes apart, the median and the largest lane gap (for the record).  The
    ``reference`` module is solved in float64 on the inputs' device,
    ``BLOCK`` lanes at a time."""
    x0s = reference.starts(inputs)
    B = x0s.shape[0]
    limit = float(cfg["feasible_below"])
    blocks, verdicts = [], []
    for a in range(0, B, BLOCK):
        lanes = slice(a, min(B, a + BLOCK))
        part = {k: v[lanes] for k, v in got.items()}
        ref = reference.solve(cfg, tree_map(lambda v: v[lanes], inputs), torch.float64)
        blocks.append(field_gaps(reference, cfg, part, ref))
        verdicts.append((part["opt_constr"].to(ref["opt_constr"].dtype) < limit) != (ref["opt_constr"] < limit))
        del ref, part
    fields = {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
    per_field = {k: dict(apart=float((v > LANE_TOL).double().mean()), median=float(v.median()),
                         max=float(v.max())) for k, v in fields.items()}  # fmt: skip
    solution = torch.stack([fields[k] for k in SOLUTION if k in fields]).amax(0)
    sensitive = torch.stack([fields[k] for k in SENSITIVE if k in fields]).amax(0)
    apart = (solution > LANE_TOL) | torch.cat(verdicts)
    roll, con = residuals(reference, cfg, x0s, got)
    numbers = dict(
        lanes_apart=float(apart.double().mean()),
        gap_median=float(solution.median()),
        sensitive_median=float(sensitive.median()),
        rollout_residual=roll,
        constr_residual=con,
    )
    return numbers, per_field
