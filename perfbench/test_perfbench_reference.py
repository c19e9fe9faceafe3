"""The plain reference of ``perfbench/reference`` against the port's own
plain version of the whole solve (``solve_flat`` on CPU tensors), and the
frozen counts against the bounds the kernels' records were given.

    python -m pytest perfbench/test_perfbench_reference.py -q
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.counts import flat_solve as counts
from perfbench.reference import flat_al_ddp

BENCH = Path(__file__).resolve().parent
CONFIGS = ("pendulum_swingup_t32", "pendulum_swingup_t200", "state_target_capped")
# the reference's state target and caps, which no configuration uses yet: the
# arrive-at-rest recipe of the port's MPC loops, [q, v] = [3.14, 0], μ ≤ 1e7
# and |multipliers| ≤ 1e5 over 30 iterations
STATE_CAPPED = dict(constraint=dict(kind="state", target=[3.14, 0.0], active_ts=[8], advance_times=2),
                    max_iterations=30, mu_max=1e7, mult_max=1e5)  # fmt: skip


def small_config(name, T=8, iterations=None):
    if name == "state_target_capped":
        cfg = {**json.loads((BENCH / "configs" / "pendulum_swingup_t32.json").read_text()), **STATE_CAPPED}
    else:
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["horizon"] = T
    cfg["constraint"] = dict(cfg["constraint"], active_ts=[T])
    if iterations is not None:
        cfg["max_iterations"] = iterations
    return cfg


def starts(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1)


def port_solve(cfg, x0s):
    from ddp_tpu_torch.convert import problem_from_numpy
    from ddp_tpu_torch.kernels.flat_solve import solve_flat
    from ddp_tpu_torch.solver.solve import Method, SolverParams

    problem = problem_from_numpy(cfg, device="cpu", dtype=torch.float64)
    params = SolverParams(**{k: cfg[k] for k in SolverParams._fields if k in cfg})
    r = solve_flat(problem, params, x0s, method=Method(cfg["method"]), n_linesearch=cfg["n_linesearch"])
    return dict(us=r.us, xs=r.xs, fb_k=r.fb_k, fb_K=r.fb_K, mult_val=r.mults.val, mult_jac=r.mults.jac,
                mult_origin=r.mults.origin, opt_constr=r.opt_constr, opt_lag=r.opt_lag, mu=r.mu, reg=r.reg,
                w=r.w, n=r.n)  # fmt: skip


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_port_plain_version_f64(name):
    """B = 8, T = 8, float64: every field within 1e-9 of its scale, μ and reg
    equal, on both configurations' classes and the capped state target
    (their own iteration budgets and caps).  The feedforward gains are held
    at the controls' scale: they are the correction to u, and at a capped
    μ = 1e7 float64's
    rounding of the constraint moves them by ~1e-9 of |u| (~5e-7 of their
    own 1e-6)."""
    cfg = small_config(name)
    x0s = torch.tensor(starts(8, 7), dtype=torch.float64)
    ref = flat_al_ddp.solve(cfg, x0s, torch.float64)
    got = port_solve(cfg, x0s)
    assert set(ref) == set(got)
    for key in ref:
        r, g = ref[key], got[key]
        assert r.shape == g.shape, key
        scale = max(float(r.abs().max()), float(ref["us"].abs().max()) if key == "fb_k" else 0.0, 1e-12)
        assert float((g - r).abs().max()) <= 1e-9 * scale, key
    assert torch.equal(ref["mu"], got["mu"]) and torch.equal(ref["reg"], got["reg"])


def test_reference_caps_bind():
    """The caps are held: μ never passes mu_max and reaches it, and no
    multiplier Jacobian passes mult_max (the values are re-anchored after
    their update, so they may pass it by jac·Δx); the swing-up's recipe
    solves its lanes."""
    cfg = small_config("state_target_capped", T=16)
    ref = flat_al_ddp.solve(cfg, torch.tensor(starts(16, 3)), torch.float64)
    assert float(ref["mu"].max()) == cfg["mu_max"]
    assert float(ref["mult_jac"].abs().max()) <= cfg["mult_max"]
    swing = json.loads((BENCH / "configs" / "pendulum_swingup_t32.json").read_text())
    ref = flat_al_ddp.solve(swing, torch.tensor(starts(64, 5)), torch.float64)
    assert float(ref["opt_constr"].max()) < swing["feasible_below"]


@pytest.mark.parametrize(
    "name, lanes, bound_ms",
    [("pendulum_swingup_t32", 4096, 0.00574), ("pendulum_swingup_t200", 4096, 0.03590)],
)
def test_counts_reproduce_the_recorded_bounds(name, lanes, bound_ms):
    """The frozen counts give the bounds the kernel's records carry for the
    headline and bench.py's T200 row at B = 4,096, bound by operations, and scale with
    the lanes."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = counts.solve_counts(cfg, lanes)
    assert c["bound_by"] == "operations"
    assert round(c["bound_ms"], 5) == bound_ms
    assert counts.solve_counts(cfg, 8 * lanes)["bound_ms"] == pytest.approx(8 * c["bound_ms"])
