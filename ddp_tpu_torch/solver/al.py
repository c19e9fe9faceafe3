"""Augmented-Lagrangian machinery: multipliers, AL cost, optimality measures
(≙ ddp_tpu/solver/al.py), for batch-major trajectories.

Multipliers are state-affine functions per timestep:
    p_t(x) = val_t + jac_t · (x ⊖ origin_t)
Constant multipliers are the jac ≡ 0 special case.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ddp_tpu_torch.models.base import state_difference, state_difference_jacobian


class AffineMults(NamedTuple):
    """Per-step affine vector function sequence, leading batch dims first."""

    val: torch.Tensor  # [..., T, m]
    jac: torch.Tensor  # [..., T, m, ndx]
    origin: torch.Tensor  # [..., T, nx]


@contextlib.contextmanager
def full_fp32_matmuls():
    """Full-float32 matmuls on the card inside, whatever the caller's
    ``matmul_precision`` allowed outside; restored on exit.  Wraps the stages
    ddp_tpu pins to "highest" (the Riccati sweep, the optimality adjoints,
    ``update_origin``), where TF32 noise trips the multiplier gates, and the
    eager line searches (their rollouts and AL cost): ddp_tpu's "high" is
    bf16×3, close to float32, but TF32 keeps a 10-bit mantissa, and in the
    line search it costs the arm fleet most of its feasible lanes.  No effect
    on the CPU."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def matmul_precision(precision):
    """float32 matmul precision on the card for the duration of a solve:
    "highest" → full float32, "high"/"default" → TF32 allowed, None → the
    process setting untouched.  Restored on exit; no effect on the CPU.  The
    gate-critical stages stay in full float32 under any setting
    (``full_fp32_matmuls``)."""
    if precision is None:
        yield
        return
    if precision not in ("highest", "high", "default"):
        raise ValueError(
            f"unknown matmul_precision {precision!r}; have None, 'highest', 'high', 'default'"
        )
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mv(A, x):
    """Batched matrix-vector product A·x: [..., r, c] × [..., c] → [..., r]."""
    return (A @ x[..., None])[..., 0]


def tmv(A, x):
    """Batched Aᵀ·x: [..., r, c] × [..., r] → [..., c]."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def init_multipliers(problem, xs, jac_init: torch.Tensor | None = None) -> AffineMults:
    """Zero multipliers anchored at the trajectory states xs [..., T+1, nx].
    ``jac_init`` [..., T, ne, ndx] replaces the zero state-feedback term: the
    reference starts from a random one (ddp.hpp:759-764); zeros converge to
    the same optimum."""
    T, ne, ndx = problem.horizon, problem.ne, problem.ndx
    batch = xs.shape[:-2]
    kw = dict(dtype=xs.dtype, device=xs.device)
    jac = torch.zeros(batch + (T, ne, ndx), **kw) if jac_init is None else jac_init
    return AffineMults(val=torch.zeros(batch + (T, ne), **kw), jac=jac, origin=xs[..., :-1, :])


def eval_mults(model, mults: AffineMults, xs) -> torch.Tensor:
    """p_t(x_t) for whole trajectories: [..., T, m]."""
    return mults.val + mv(mults.jac, state_difference(model, mults.origin, xs[..., :-1, :]))


@full_fp32_matmuls()
def update_origin(model, mults: AffineMults, xs) -> AffineMults:
    """Re-expand the affine functions about a new trajectory:
    val += jac·(x_new ⊖ origin);  jac = jac·d_diff_dfinish;  origin = x_new."""
    x_new = xs[..., :-1, :]
    d = state_difference(model, mults.origin, x_new)
    J = state_difference_jacobian(model, mults.origin, x_new)
    return AffineMults(val=mults.val + mv(mults.jac, d), jac=mults.jac @ J, origin=x_new)


def al_costs(problem, xs, us, mults: AffineMults, mu) -> torch.Tensor:
    """Per-step augmented-Lagrangian cost [..., T+1]: l + p(x)·eq + (μ/2)‖eq‖²,
    with lf(x_T) in the last slot; ``mu`` has the leading batch shape.

    The constraint penalty is evaluated only at the statically-active
    timesteps — inactive steps contribute exactly zero."""
    T = problem.horizon
    ts = torch.arange(T, device=xs.device)
    stage = problem.cost.stage(ts, xs[..., :-1, :], us)
    active = problem.active_ts()
    if problem.ne and active:
        mask = torch.as_tensor(problem.eq_mask(), dtype=xs.dtype, device=xs.device)
        ts_a = torch.as_tensor(active, device=xs.device)
        x_a = xs[..., ts_a, :]
        p = mults.val[..., ts_a, :] + mv(
            mults.jac[..., ts_a, :, :],
            state_difference(problem.model, mults.origin[..., ts_a, :], x_a),
        )
        ce = problem.constraint.value(ts_a, x_a, us[..., ts_a, :]) * mask[ts_a]
        pen = torch.sum(p * ce, dim=-1) + 0.5 * mu[..., None] * torch.sum(ce * ce, dim=-1)
        stage = stage.clone()
        stage[..., ts_a] += pen
    return torch.cat([stage, problem.cost.terminal(xs[..., -1, :])[..., None]], dim=-1)


def optimality_constr(derivs) -> torch.Tensor:
    """max_t ‖eq_t‖ per trajectory: [...]."""
    norms = torch.linalg.vector_norm(derivs.eq, dim=-1)
    if norms.shape[-1] == 0:
        return norms.new_zeros(norms.shape[:-1])
    return norms.amax(dim=-1)


def _scaled_norm(x):
    """‖x‖ over the last axis, where the plain sum of squares overflows (an
    entry past 1.8e19 in float32) taken as max|x| · ‖x / max|x|‖; the plain
    norm's bits everywhere else."""
    n = torch.linalg.vector_norm(x, dim=-1)
    big = x.abs().amax(dim=-1)
    scaled = big * torch.linalg.vector_norm(x / big[..., None], dim=-1)
    return torch.where(torch.isinf(n) & torch.isfinite(big), scaled, n)


@full_fp32_matmuls()
def _adjoint_scores(derivs, mult_val, mult_jac, mu):
    """Reverse adjoint recursion shared by optimality_obj/lag over
    trajectories with any leading batch dims (none for one trajectory, whose
    2-D products give ``ddp_tpu``'s bits on the CPU); ``mu`` None drops the
    μ·eq penalty terms.  The lag measure is only reported, so its norm is
    kept from overflowing on a lane whose multipliers raced past 1e19 in
    float32; the obj measure feeds the plateau gate and keeps the plain norm,
    as ddp_tpu's, so the AL schedule stays the reference's."""
    norm = (lambda x: torch.linalg.vector_norm(x, dim=-1)) if mu is not None else _scaled_norm
    adj = derivs.lfx
    scores = []
    for t in reversed(range(derivs.lx.shape[-2])):
        lu, fu, eqv = derivs.lu[..., t, :], derivs.fu[..., t, :, :], derivs.eq[..., t, :]
        eqx, equ = derivs.eqx[..., t, :, :], derivs.equ[..., t, :, :]
        pe, pex = mult_val[..., t, :], mult_jac[..., t, :, :]
        fx, lx = derivs.fx[..., t, :, :], derivs.lx[..., t, :]
        if mu is None:
            lu_aug = lu + tmv(equ, pe) + tmv(fu, adj)
            adj = tmv(fx, adj) + lx + tmv(eqx, pe) + tmv(pex, eqv)
        else:
            m = mu[..., None]
            lu_aug = lu + tmv(equ, pe) + m * tmv(equ, eqv) + tmv(fu, adj)
            adj = tmv(fx, adj) + lx + m * tmv(eqx, eqv) + tmv(eqx, pe) + tmv(pex, eqv)
        scores.append(norm(lu_aug))
    return torch.stack(scores, dim=-1).amax(dim=-1)


def optimality_obj(problem, derivs, mult_val, mult_jac, mu) -> torch.Tensor:
    """max_t ‖∂L_aug/∂u_t‖ per trajectory via the reverse adjoint recursion.
    ``mult_val``/``mult_jac`` must be expressed at the trajectory (origin ==
    x_t), which update_origin guarantees."""
    del problem
    return _adjoint_scores(derivs, mult_val, mult_jac, mu)


def optimality_lag(problem, derivs, mult_val, mult_jac) -> torch.Tensor:
    """Same recursion without the μ·eq penalty terms."""
    del problem
    return _adjoint_scores(derivs, mult_val, mult_jac, None)
