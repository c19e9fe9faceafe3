"""Receding-horizon MPC driver with warm starts (≙ ddp_tpu/solver/mpc.py).

A replan advances the warm start, re-solves with a fixed (small) iteration
budget through ``solve_batched`` at B = 1, and returns the first control and
the feedback gains.  ``make_mpc_step`` returns a plain function: nothing is
compiled, and each replan runs ``solve_batched`` eagerly on the device of
the measured state.

Warm starts carry the full solver state between replans, not just the
controls: ``MPCCarry`` holds (us_warm, mults, μ, reg, w, n), the next replan
re-anchors the affine multipliers at its warm-start rollout and resumes the
penalty and gate-tolerance schedule where the last one left off.  An MPC
loop that re-initialised the multipliers would re-pay the AL feasibility
ramp inside every replan's small budget.

Multiplier time-shifting: the constraint schedule is horizon-relative
(``active_ts`` are slot indices), so by default the slot-t multiplier
warm-starts slot t of the next replan unshifted; ``shift_mults=True`` shifts
the sequence one step with the controls, for time-indexed path constraints
that slide through the horizon window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddp_tpu_torch.models.base import state_neutral
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.solve import Method, SolverParams


class MPCCarry(NamedTuple):
    """Warm-start state carried between replans (persist with
    utils/checkpoint.py to resume a restarted controller host)."""

    us_warm: torch.Tensor  # [T, nu]
    mults: al_mod.AffineMults  # [T, ne] / [T, ne, ndx] / [T, nx]
    mu: torch.Tensor  # [] penalty where the last replan ended
    reg: torch.Tensor  # [] regularization likewise
    # the inner-convergence gate tolerances (w, n), the rest of the
    # schedule's state.  Zero ⇒ cold (the step re-derives the params'
    # defaults), so checkpoints of older carries resume correctly.
    w: torch.Tensor | None = None  # []
    n: torch.Tensor | None = None  # []


class MPCStep(NamedTuple):
    u0: torch.Tensor  # [nu]      control to apply now
    k0: torch.Tensor  # [nu]      feedforward at t=0
    K0: torch.Tensor  # [nu, ndx] feedback gain at t=0 (for inter-replan control)
    carry: MPCCarry
    opt_constr: torch.Tensor


def _problem_kw(problem, dtype=None, device=None) -> dict:
    ref = next(problem.buffers())
    return dict(dtype=dtype or ref.dtype, device=device or ref.device)


def init_carry(problem, dtype=None, x0: torch.Tensor | None = None) -> MPCCarry:
    """Cold-start carry: zero controls and multipliers, μ = reg = w = n = 0
    (the step floors μ and reg at the params' values and takes the default
    w and n).  ``x0`` anchors the multiplier origins at a valid state (needed
    on quaternion-manifold models, where zero is not on the manifold); the
    model's neutral state at rest otherwise.  ``dtype`` and the device are
    the problem's unless given (``x0``'s device when it is)."""
    kw = _problem_kw(problem, dtype, None if x0 is None else x0.device)
    T, ne, ndx, nx = problem.horizon, problem.ne, problem.ndx, problem.nx
    if x0 is None:
        x0 = state_neutral(problem.model)
    origin = x0.to(**kw).expand(T, nx).clone()
    zero = torch.zeros((), **kw)
    return MPCCarry(
        us_warm=torch.zeros((T, problem.nu), **kw),
        mults=al_mod.AffineMults(
            val=torch.zeros((T, ne), **kw),
            jac=torch.zeros((T, ne, ndx), **kw),
            origin=origin,
        ),
        mu=zero,
        reg=zero.clone(),
        w=zero.clone(),
        n=zero.clone(),
    )


def _shift_mults(mults: al_mod.AffineMults) -> al_mod.AffineMults:
    """Shift the multiplier sequence one step with the controls (for
    time-indexed path constraints), repeating the tail slot; the time axis
    is the first."""
    return al_mod.AffineMults(*(torch.cat([a[1:], a[-1:]], dim=0) for a in mults))


def _advance_carry(res, params, warm_mults: bool, shift_mults: bool, mu_carry_max: float,
                   mu_decay: float) -> MPCCarry:  # fmt: skip
    """Build the next MPCCarry from a B = 1 BatchSolveResult.

    The carried penalty is decayed (μ/mu_decay, floored at params.mu and
    capped at ``mu_carry_max``): with warm multipliers doing the feasibility
    work, re-entering at the escalated μ pumps the update p += μ·eq into
    divergence, and resetting μ outright loses the escalation signal."""
    us = res.us[0]
    mults = al_mod.AffineMults(*(a[0] for a in res.mults))
    if shift_mults:
        mults = _shift_mults(mults)
    if not warm_mults:
        mults = mults._replace(val=torch.zeros_like(mults.val), jac=torch.zeros_like(mults.jac))
    # w is clamped at the dtype's smallest normal: w /= μ compounds across
    # replans and an underflow to 0 would read as a cold carry; any w below
    # the solver's w_min floor gates identically anyway
    return MPCCarry(
        us_warm=torch.cat([us[1:], us[-1:]], dim=0),
        mults=mults,
        mu=torch.clamp(res.mu[0] / mu_decay, min=params.mu, max=mu_carry_max),
        reg=res.reg[0],
        w=torch.clamp(res.w[0], min=torch.finfo(res.w.dtype).tiny),
        n=res.n[0],
    )


def make_mpc_step(
    problem,
    params: SolverParams,
    method=Method.PRIMAL_DUAL_AFFINE,
    backward: str = "sweep",
    forward: str = "sweep",
    n_linesearch: int | None = None,
    matmul_precision: str | None = None,
    warm_mults: bool = True,
    shift_mults: bool = False,
    mu_carry_max: float | None = None,
    mu_decay: float = 10.0,
):
    """Build the replan function: (x_measured [nx], carry) → MPCStep.

    Each replan is ``solve_batched`` on one sample with the fixed iteration
    budget of ``params``; ``backward``, ``forward``, ``n_linesearch`` and
    ``matmul_precision`` are its knobs (``backward="kernel"`` runs the
    Riccati kernel at B = 1 on a card).  ``forward="seq"`` stops the line
    search at the first accepted step, which after the first replan is
    usually the full step.

    ``warm_mults=False`` warm-starts the controls only; ``mu_carry_max``
    caps the carried penalty (default 100·params.mu) so that a persistently
    infeasible plant cannot escalate μ without bound across replans."""
    if mu_carry_max is None:
        mu_carry_max = 100.0 * params.mu
    w_def = params.w if params.w is not None else 1.0 / params.mu
    n_def = params.n if params.n is not None else params.mu**-0.1

    def _wn_warm(carry):
        """(w, n) warm state; zeros (a cold carry, an old checkpoint) → defaults."""
        if carry.w is None or carry.n is None:
            return None, None
        w = torch.where(carry.w > 0, carry.w, torch.full_like(carry.w, w_def))
        n = torch.where(carry.n > 0, carry.n, torch.full_like(carry.n, n_def))
        return w, n

    def step(x_measured: torch.Tensor, carry: MPCCarry) -> MPCStep:
        w_warm, n_warm = _wn_warm(carry)
        res = solve_batched(
            problem,
            params,
            x_measured[None],
            us_init=carry.us_warm[None],
            method=method,
            backward=backward,
            forward=forward,
            n_linesearch=n_linesearch,
            matmul_precision=matmul_precision,
            mults_init=al_mod.AffineMults(*(a[None] for a in carry.mults)) if warm_mults else None,
            mu_init=torch.clamp(carry.mu, min=params.mu)[None] if warm_mults else None,
            reg_init=torch.clamp(carry.reg, min=params.reg)[None] if warm_mults else None,
            w_init=w_warm[None] if (warm_mults and w_warm is not None) else None,
            n_init=n_warm[None] if (warm_mults and n_warm is not None) else None,
        )
        return MPCStep(
            u0=res.us[0, 0],
            k0=res.fb_k[0, 0],
            K0=res.fb_K[0, 0],
            carry=_advance_carry(res, params, warm_mults, shift_mults, mu_carry_max, mu_decay),
            opt_constr=res.opt_constr[0],
        )

    return step


def _map_carry(fn, carry: MPCCarry) -> MPCCarry:
    """``fn`` applied to every tensor of a carry (a None leaf stays None)."""
    return MPCCarry(*(
        None if a is None else al_mod.AffineMults(*map(fn, a)) if isinstance(a, al_mod.AffineMults) else fn(a)
        for a in carry
    ))  # fmt: skip


def make_batch_mpc_step(
    problem,
    params: SolverParams,
    mesh,
    method=Method.PRIMAL_DUAL_AFFINE,
    backward: str = "sweep",
    forward: str = "sweep",
    n_linesearch: int | None = None,
    matmul_precision: str | None = None,
    warm_mults: bool = True,
    shift_mults: bool = False,
    mu_carry_max: float | None = None,
    mu_decay: float = 10.0,
):
    """Fleet MPC: replan a batch of scenarios split over the ranks of a
    device mesh (``parallel/mesh.py``).

    BASELINE configs[4]: "multi-host receding-horizon MPC: 32k scenarios
    across N hosts, 10 ms replan budget".  Returns
    step(x_measured [B, nx], carry) → (u0 [B, nu], carry', mean_constr): each
    rank replans its B/n scenarios through ``solve_batched`` warm-started on
    their carry (controls shifted one step, multipliers, μ, reg, w, n, as
    ``make_mpc_step``'s), and the convergence aggregate is all-reduced over
    the mesh.  ``x_measured`` and the carry's leaves are global batches (the
    same on every rank) or DTensors sharded ``Shard(0)`` on ``mesh``; u0 and
    the carry come back as such DTensors, ``mean_constr`` a plain tensor.
    Build the first carry with ``init_batch_carry``; a carry whose ``w`` or
    ``n`` is None (a checkpoint from before they were carried) resumes with
    the params' defaults.  The knobs are ``make_mpc_step``'s."""
    from ddp_tpu_torch.parallel.mesh import global_mean, local_block, sharded

    if mu_carry_max is None:
        mu_carry_max = 100.0 * params.mu
    w_def = params.w if params.w is not None else 1.0 / params.mu
    n_def = params.n if params.n is not None else params.mu**-0.1

    def step(x, carry):
        x, carry = local_block(x, mesh), _map_carry(lambda a: local_block(a, mesh), carry)
        # legacy checkpoints (pre-(w, n) MPCCarry) restore with w=None/n=None:
        # zeros, which the where(… > 0, …) below turns into the defaults
        if carry.w is None or carry.n is None:
            z = torch.zeros_like(carry.mu)
            carry = carry._replace(w=z if carry.w is None else carry.w,
                                   n=z if carry.n is None else carry.n)  # fmt: skip
        us_warm, mults, mu, reg, w_c, n_c = carry
        w_warm = torch.where(w_c > 0, w_c, torch.full_like(w_c, w_def))
        n_warm = torch.where(n_c > 0, n_c, torch.full_like(n_c, n_def))
        res = solve_batched(
            problem, params, x, us_init=us_warm, method=method, backward=backward,
            forward=forward, n_linesearch=n_linesearch, matmul_precision=matmul_precision,
            mults_init=mults if warm_mults else None,
            mu_init=torch.clamp(mu, min=params.mu) if warm_mults else None,
            reg_init=torch.clamp(reg, min=params.reg) if warm_mults else None,
            w_init=w_warm if warm_mults else None,
            n_init=n_warm if warm_mults else None,
        )  # fmt: skip
        mults_next = res.mults
        if shift_mults:
            mults_next = torch.vmap(_shift_mults)(mults_next)
        if not warm_mults:
            mults_next = mults_next._replace(val=torch.zeros_like(mults_next.val),
                                             jac=torch.zeros_like(mults_next.jac))  # fmt: skip
        carry_next = MPCCarry(
            us_warm=torch.cat([res.us[:, 1:], res.us[:, -1:]], dim=1),
            mults=mults_next,
            mu=torch.clamp(res.mu / mu_decay, min=params.mu, max=mu_carry_max),
            reg=res.reg,
            w=torch.clamp(res.w, min=torch.finfo(res.w.dtype).tiny),
            n=res.n,
        )
        carry_next = _map_carry(lambda a: sharded(a, mesh), carry_next)
        return sharded(res.us[:, 0], mesh), carry_next, global_mean(res.opt_constr, mesh)

    return step


def init_batch_carry(problem, B: int, dtype=None, x0s: torch.Tensor | None = None) -> MPCCarry:
    """Batched cold-start carry for ``make_batch_mpc_step`` ([B, …] leaves),
    each lane's multiplier origin at its own ``x0s`` row when given."""
    one = init_carry(problem, dtype, None if x0s is None else x0s[0])
    carry = _map_carry(lambda a: a.expand((B,) + a.shape).clone(), one)
    if x0s is not None:
        origin = x0s.to(carry.mu.dtype)[:, None, :].expand(B, problem.horizon, problem.nx).clone()
        carry = carry._replace(mults=carry.mults._replace(origin=origin))
    return carry


def run_mpc(
    problem,
    params: SolverParams,
    x0: torch.Tensor,
    n_steps: int,
    plant=None,
    method=Method.PRIMAL_DUAL_AFFINE,
):
    """Closed-loop rollout: replan at every step and apply u0 to the plant
    (the problem's own dynamics by default).  Returns (xs [n_steps+1, nx],
    us [n_steps, nu], opt_constr [n_steps])."""
    plant = plant or problem.dynamics
    carry = init_carry(problem, dtype=x0.dtype, x0=x0)
    x, xs, us, ocs = x0, [], [], []
    for t in range(n_steps):
        out = _step_impl(problem, params, method, x, carry)
        xs.append(x)
        us.append(out.u0)
        ocs.append(out.opt_constr)
        x, carry = plant(t, x, out.u0), out.carry
    return torch.stack(xs + [x]), torch.stack(us), torch.stack(ocs)


def _step_impl(problem, params, method, x_measured, carry):
    res = solve_batched(
        problem,
        params,
        x_measured[None],
        us_init=carry.us_warm[None],
        method=method,
        mults_init=al_mod.AffineMults(*(a[None] for a in carry.mults)),
        mu_init=torch.clamp(carry.mu, min=params.mu)[None],
        reg_init=torch.clamp(carry.reg, min=params.reg)[None],
    )
    return MPCStep(
        u0=res.us[0, 0],
        k0=res.fb_k[0, 0],
        K0=res.fb_K[0, 0],
        carry=_advance_carry(
            res, params, warm_mults=True, shift_mults=False,
            mu_carry_max=100.0 * params.mu, mu_decay=10.0,
        ),  # fmt: skip
        opt_constr=res.opt_constr[0],
    )
