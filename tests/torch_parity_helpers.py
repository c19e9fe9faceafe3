"""Shared constructors for the ddp_tpu ↔ ddp_tpu_torch parity tests: the same
problem and the same numpy-seeded inputs handed to both packages."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from ddp_tpu.models.pendulum import pendulum
from ddp_tpu.ocp import constraints, costs, dynamics
from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.ocp.problem import Problem
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.ocp.problem import Derivs as TDerivs

TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def jax_pendulum_problem(horizon, dtype, target=3.14):
    """The headline problem (bench.py): Euler pendulum, ½‖u‖² cost, a
    configuration target at the horizon advanced twice, Gauss-Newton."""
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray([target], dtype), active_ts=(horizon,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
        second_order=False,
    )


def spec_of(problem) -> dict:
    """problem_from_numpy's spec, read from a ddp_tpu Problem's leaves."""
    con, times = problem.constraint, 0
    while isinstance(con, constraints.AdvanceTime):
        con, times = con.inner, times + 1
    return dict(
        mass=np.asarray(problem.model.mass),
        length=np.asarray(problem.model.length),
        dt=np.asarray(problem.dynamics.dt),
        c=np.asarray(problem.cost.c),
        target=np.asarray(con.target),
        active_ts=con.active_ts,
        advance_times=times,
        horizon=problem.horizon,
        second_order=problem.second_order,
    )


def both_problems(horizon, np_dtype, **kw):
    jp = jax_pendulum_problem(horizon, jnp.dtype(np_dtype), **kw)
    tp = problem_from_numpy(spec_of(jp), device="cpu", dtype=TORCH_DTYPE[np_dtype])
    return jp, tp


def headline_x0s(B, np_dtype):
    """bench.py's initial states: q ~ U(-π, π) from default_rng(0), v = 0."""
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1).astype(np_dtype)


def t(x):
    """numpy/JAX array → CPU torch tensor of the same dtype."""
    return torch.from_numpy(np.array(x))


def random_spd_derivs(B, T, n, m, e, seed, np_dtype=np.float64):
    """Random Gauss-Newton derivative blocks [B, T, …] (numpy) at arbitrary
    dims: stable fx near I, a PSD stage-cost Hessian with an SPD luu block,
    non-trivial constraint rows and multipliers.  Returns (fields, pe, pex)."""
    rng = np.random.default_rng(seed)
    nz = n + m
    G = rng.normal(size=(B, T, nz, nz)) / np.sqrt(nz)
    lzz = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(nz)
    lfG = rng.normal(size=(B, n, n)) / np.sqrt(n)
    f = dict(
        lx=rng.normal(size=(B, T, n)),
        lu=rng.normal(size=(B, T, m)),
        lxx=lzz[..., :n, :n],
        lux=lzz[..., n:, :n],
        luu=lzz[..., n:, n:],
        fx=np.eye(n) + 0.05 * rng.normal(size=(B, T, n, n)),
        fu=0.1 * rng.normal(size=(B, T, n, m)),
        fxx=np.zeros((B, T, n, n, n)),
        fux=np.zeros((B, T, n, m, n)),
        fuu=np.zeros((B, T, n, m, m)),
        eq=0.1 * rng.normal(size=(B, T, e)),
        eqx=0.1 * rng.normal(size=(B, T, e, n)),
        equ=0.1 * rng.normal(size=(B, T, e, m)),
        eqxx=np.zeros((B, T, e, n, n)),
        equx=np.zeros((B, T, e, m, n)),
        equu=np.zeros((B, T, e, m, m)),
        lfx=rng.normal(size=(B, n)),
        lfxx=lfG @ np.swapaxes(lfG, -1, -2) + 0.1 * np.eye(n),
    )
    f = {k: np.ascontiguousarray(v, dtype=np_dtype) for k, v in f.items()}
    pe = (0.3 * rng.normal(size=(B, T, e))).astype(np_dtype)
    pex = (0.01 * rng.normal(size=(B, T, e, n))).astype(np_dtype)
    return f, pe, pex


def to_jax_derivs(fields):
    return JDerivs(**{k: jnp.asarray(v) for k, v in fields.items()})


def to_torch_derivs(fields):
    return TDerivs(**{k: t(v) for k, v in fields.items()})
