"""Top-level equality-constrained DDP solve of one trajectory: the
augmented-Lagrangian outer loop (≙ ddp_tpu/solver/solve.py).

Control flow, as the reference's (ddp.hpp:744-842) and ``ddp_tpu``'s:

    outer loop with early exit         Python while, ``done`` read each iteration
    multiplier update decision tree    0-d tensor updates (torch.where)
    backward restart loop              riccati.backward_pass
    line-search halving loop           rollout.forward_pass

``solve`` runs one trajectory; the batched throughput path is
``solver/batched.py::solve_batched``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ddp_tpu_torch.diagnostics.asserts import ddp_assert, val
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.riccati import backward_pass
from ddp_tpu_torch.solver.rollout import forward_pass


class Method(enum.Enum):
    """PRIMAL and PRIMAL_DUAL_CONSTANT keep the multiplier state-independent
    (jac pinned to zero); AFFINE gives multipliers a state-feedback term
    re-expanded each iteration.  PRIMAL additionally drops the control-
    feedback correction from the multiplier update: p += μ·eq instead of
    p += μ·(eq + eq_u·k) (see ddp_tpu.solver.solve.Method)."""

    PRIMAL = "primal"
    PRIMAL_DUAL_CONSTANT = "primal_dual_constant_multipliers"
    PRIMAL_DUAL_AFFINE = "primal_dual_affine_multipliers"


class SolverParams(NamedTuple):
    """AL schedule parameters.  w/n default to w = 1/μ, n = 1/μ^0.1.

    - ``w_min``: floor on the inner-convergence tolerance w; None → scaled
      to the dtype as 10·sqrt(eps).
    - ``inner_iters_max``: bound on inner Newton iterations between
      multiplier/μ updates; None → the gate opens only via w or the
      plateau test.
    - ``mu_factor``/``mu_max``: penalty growth on update failure and its cap.
    - ``mult_max``: elementwise clip of the multipliers after each update
      (needed whenever mu_max is finite).
    """

    max_iterations: int
    threshold: float
    mu: float
    reg: float = 0.0
    w: float | None = None
    n: float | None = None
    w_min: float | None = None
    inner_iters_max: int | None = None
    mu_factor: float = 10.0
    mu_max: float | None = None
    mult_max: float | None = None


class SolveStats(NamedTuple):
    iterations: torch.Tensor
    opt_lag: torch.Tensor  # μ-free Lagrangian stationarity (the stopping measure)
    opt_obj: torch.Tensor  # μ-dependent AL stationarity (the update-gate measure)
    opt_constr: torch.Tensor
    mu: torch.Tensor
    reg: torch.Tensor
    step: torch.Tensor
    converged: torch.Tensor


class SolveHistory(NamedTuple):
    """Per-iteration solver state, stacked over the iteration axis [I]; rows
    after convergence repeat the converged state."""

    mu: torch.Tensor  # penalty after this iteration's update decision
    reg: torch.Tensor  # regularization after the backward/forward pair
    w: torch.Tensor  # inner-convergence tolerance
    n: torch.Tensor  # constraint-progress tolerance
    step: torch.Tensor  # accepted line-search step
    opt_obj: torch.Tensor
    opt_lag: torch.Tensor
    opt_constr: torch.Tensor
    upd_success: torch.Tensor  # bool: the first-order multiplier update fired
    upd_failure: torch.Tensor  # bool: the μ escalation fired
    done: torch.Tensor  # bool: converged at iteration start


class SolveResult(NamedTuple):
    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    fb_k: torch.Tensor  # [T, nu]       feedforward (for MPC warm starts)
    fb_K: torch.Tensor  # [T, nu, ndx]  feedback gains
    mults: object  # al.AffineMults [T, …]
    stats: SolveStats
    history: SolveHistory | None = None  # solve(..., history=True) only


class _Carry(NamedTuple):
    it: int
    done: bool
    xs: torch.Tensor
    us: torch.Tensor
    mults: object
    fb: object  # AffineMults of the last committed gains (k, K, origin)
    mu: torch.Tensor
    reg: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    opt_lag: torch.Tensor
    opt_constr: torch.Tensor
    step: torch.Tensor
    opt_obj_prev: torch.Tensor
    just_changed: bool  # (p, μ) changed last iteration
    inner: int  # inner iterations since the last (p, μ) change


def solve(
    problem,
    params: SolverParams,
    x_init: torch.Tensor,
    us_init: torch.Tensor | None = None,
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    precise: bool | str = False,
    mults_init_jac: torch.Tensor | None = None,
    history: bool = False,
    matmul_precision: str | None = None,
    reference_schedule: bool = False,
) -> SolveResult:
    """Solve one trajectory from ``x_init`` [nx] (controls ``us_init``
    [T, nu], zeros by default) on the device and in the dtype of ``x_init``,
    which the problem's buffers must share.

    ``mults_init_jac`` [T, ne, ndx]: the multipliers' initial state-feedback
    term (the reference's random startup, ddp.hpp:760-764).
    ``history=True`` records per-iteration state (``SolveHistory``) and runs
    all ``max_iterations`` rows, the converged state repeated, with the same
    final iterate.  ``matmul_precision``: None | "highest" | "high" |
    "default", as ``solve_batched``'s; the backward pass, the line search,
    the optimality adjoints and ``update_origin`` run in full float32 under
    any setting.  ``reference_schedule=True`` runs the reference's exact
    outer loop: the raw ``opt_obj < w`` gate (no w_min floor, plateau or
    inner cap), μ·``mu_factor`` on failure with w and n unchanged, on
    success n = opt_obj(new multipliers)/μ^0.1 and w /= μ, stopping on
    opt_obj, and the pre-loop forward result discarded.

    ``precise=True|"storage"`` (``ddp_tpu``'s double-float stages) is not
    ported: it raises ``NotImplementedError``."""
    if precise:
        raise NotImplementedError(
            "solve(precise=...) is still to be ported (ROADMAP Queue 1, item 6: "
            "the precision envelope as float64 arithmetic)"
        )
    with al_mod.matmul_precision(matmul_precision):
        return _solve(
            problem, params, x_init, us_init, method, mults_init_jac, history, reference_schedule
        )


def _solve(problem, params, x_init, us_init, method, mults_init_jac, history, reference_schedule):
    T, nu = problem.horizon, problem.nu
    model = problem.model
    dtype, device = x_init.dtype, x_init.device
    ref = next(problem.buffers())
    if ref.device != device or ref.dtype != dtype:
        raise ValueError(
            f"x_init is {dtype} on {device} but the problem is {ref.dtype} on "
            f"{ref.device}; move one with .to(device, dtype)"
        )
    ddp_assert(
        val(tuple(x_init.shape), "x_init.shape") == (problem.nx,),
        val(params.max_iterations, "max_iterations") >= 1,
        val(params.mu, "mu") > 0.0,
        msg="solve() preconditions",
    )
    kw = dict(dtype=dtype, device=device)
    if us_init is None:
        us_init = torch.zeros((T, nu), **kw)
    else:
        ddp_assert(
            val(tuple(us_init.shape), "us_init.shape") == (T, nu),
            msg="warm-start shape",
        )
    xs = problem.rollout(x_init, us_init)
    us = us_init

    def scalar(v):
        return torch.tensor(v, **kw)

    mu = scalar(params.mu)
    reg = scalar(params.reg)
    w = scalar(params.w if params.w is not None else 1.0 / params.mu)
    n = scalar(params.n if params.n is not None else 1.0 / params.mu**0.1)
    threshold = scalar(params.threshold)
    eps = scalar(torch.finfo(dtype).eps)
    w_min = scalar(params.w_min) if params.w_min is not None else 10.0 * eps**0.5
    affine = method is Method.PRIMAL_DUAL_AFFINE

    def constrain_jac(jac):
        # constant-multiplier methods never grow a state-feedback term
        return jac if affine else torch.zeros_like(jac)

    def derivatives(xs_, us_):
        """Problem.derivatives of the one trajectory, batch dim dropped."""
        d = problem.derivatives(xs_[None], us_[None])
        return type(d)(*(f[0] for f in d))

    def opt_obj_of(d, mults, mu_):
        return al_mod.optimality_obj(problem, d, mults.val, mults.jac, mu_)

    mults = al_mod.init_multipliers(problem, xs, jac_init=mults_init_jac)
    mults = mults._replace(jac=constrain_jac(mults.jac))

    # --- pre-loop: derivatives → backward → forward (ddp.hpp:768-773) ---
    derivs = derivatives(xs, us)
    bres = backward_pass(derivs, mults.val, mults.jac, mu, reg)
    mu = bres.mu
    fwd = forward_pass(problem, xs, us, bres.k, bres.K, mults, mu)
    fb = al_mod.AffineMults(bres.k, bres.K, xs[:-1])
    if not reference_schedule:
        # the reference never swaps the pre-loop forward's trajectory in;
        # keeping it is ddp_tpu's documented improvement
        xs, us = fwd.xs, fwd.us
    inf = scalar(float("inf"))

    def body(c: _Carry):
        """One outer iteration (update_derivatives, ddp.hpp:641-696, then
        the backward/forward pair, ddp.hpp:804-826): the new carry and the
        iteration's history row."""
        derivs = derivatives(c.xs, c.us)
        mults = al_mod.update_origin(model, c.mults, c.xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
        fbm = al_mod.update_origin(model, c.fb, c.xs)
        opt_obj = opt_obj_of(derivs, mults, c.mu)
        opt_constr = al_mod.optimality_constr(derivs)
        # stopping uses the μ-free Lagrangian stationarity: opt_obj carries
        # μ·eqᵀeq_u terms whose float floor is μ·eps
        opt_lag = al_mod.optimality_lag(problem, derivs, mults.val, mults.jac)

        if reference_schedule:
            done = (opt_obj < threshold) & (opt_constr < threshold)
            gate = opt_obj < c.w
        else:
            done = (opt_lag < threshold) & (opt_constr < threshold)
            # the reference's opt_obj < w with a dtype floor, and a plateau
            # test (see SolverParams)
            plateau = (opt_obj >= 0.1 * c.opt_obj_prev) & (not c.just_changed)
            gate = (opt_obj < torch.maximum(c.w, w_min)) | plateau
            if params.inner_iters_max is not None:
                gate = gate | (c.inner >= params.inner_iters_max)
        done, gate = bool(done), bool(gate)
        upd_success = not done and gate and bool(opt_constr < c.n)
        upd_failure = not done and gate and bool(opt_constr >= c.n)
        if done:
            # the carry freezes: nothing below would be kept
            row = (c.mu, c.reg, c.w, c.n, c.step, opt_obj, opt_lag, opt_constr, False, False, True)
            new_c = c._replace(
                it=c.it if c.done else c.it + 1, done=True, opt_lag=opt_lag,
                opt_constr=opt_constr, opt_obj_prev=opt_obj, just_changed=False,
                inner=c.inner + 1,
            )  # fmt: skip
            return new_c, row

        # first-order AL multiplier update (ddp.hpp:680-688):
        #   p += μ (eq + eq_u·k);  p_x += μ (eq_x + eq_u·K)
        # PRIMAL uses no multiplier feedback: p += μ·eq only
        gain = c.mu if upd_success else torch.zeros_like(c.mu)
        if method is Method.PRIMAL:
            fb_term = torch.zeros_like(derivs.eq)
            fb_term_jac = torch.zeros_like(derivs.eqx)
        else:
            fb_term = torch.einsum("tou,tu->to", derivs.equ, fbm.val)
            fb_term_jac = torch.einsum("tou,tuj->toj", derivs.equ, fbm.jac)
        new_val = mults.val + gain * (derivs.eq + fb_term)
        new_jac = mults.jac + gain * (derivs.eqx + fb_term_jac)
        if params.mult_max is not None:
            new_val = torch.clamp(new_val, -params.mult_max, params.mult_max)
            new_jac = torch.clamp(new_jac, -params.mult_max, params.mult_max)
        mults = mults._replace(val=new_val, jac=constrain_jac(new_jac))

        mu_new = c.mu * params.mu_factor if upd_failure else c.mu
        if params.mu_max is not None:
            mu_new = torch.minimum(mu_new, scalar(params.mu_max))
        if reference_schedule:
            # ddp.hpp:787-797: on success n = opt_obj with the updated
            # multipliers / μ^0.1 and w /= μ; on failure only μ grows
            n_new = opt_obj_of(derivs, mults, c.mu) / c.mu**0.1 if upd_success else c.n
        elif upd_success:
            n_new = torch.maximum(c.n * c.mu**-0.9, threshold)
        else:
            n_new = mu_new**-0.1 if upd_failure else c.n
        w_new = c.w / c.mu if upd_success else c.w

        bres = backward_pass(derivs, mults.val, mults.jac, mu_new, c.reg)
        fwd = forward_pass(problem, c.xs, c.us, bres.k, bres.K, mults, bres.mu)
        reg = torch.where(
            fwd.step >= 0.5,
            torch.where(bres.reg / 2 < 1e-5, torch.zeros_like(bres.reg), bres.reg / 2),
            bres.reg,
        )
        changed = upd_success or upd_failure
        row = (bres.mu, reg, w_new, n_new, fwd.step, opt_obj, opt_lag, opt_constr,
               upd_success, upd_failure, False)  # fmt: skip
        new_c = _Carry(
            it=c.it + 1, done=False, xs=fwd.xs, us=fwd.us, mults=mults,
            fb=al_mod.AffineMults(bres.k, bres.K, c.xs[:-1]), mu=bres.mu, reg=reg,
            w=w_new, n=n_new, opt_lag=opt_lag, opt_constr=opt_constr, step=fwd.step,
            opt_obj_prev=opt_obj, just_changed=changed, inner=1 if changed else c.inner + 1,
        )  # fmt: skip
        return new_c, row

    c = _Carry(
        it=0, done=False, xs=xs, us=us, mults=mults, fb=fb, mu=mu, reg=reg, w=w, n=n,
        opt_lag=inf, opt_constr=inf, step=fwd.step, opt_obj_prev=inf, just_changed=True,
        inner=1,  # the pre-loop backward/forward already ran
    )  # fmt: skip
    rows = []
    while c.it < params.max_iterations and not c.done:
        c, row = body(c)
        rows.append(row)
    hist = None
    if history:
        # the converged state repeats its row to the fixed length
        rows += [rows[-1]] * (params.max_iterations - len(rows))
        cols = list(zip(*rows))
        flags = [torch.tensor(col, dtype=torch.bool, device=device) for col in cols[8:]]
        hist = SolveHistory(*(torch.stack(col) for col in cols[:8]), *flags)
    return SolveResult(
        xs=c.xs,
        us=c.us,
        fb_k=c.fb.val,
        fb_K=c.fb.jac,
        mults=c.mults,
        stats=SolveStats(
            iterations=torch.tensor(c.it, device=device),
            opt_lag=c.opt_lag,
            opt_obj=c.opt_obj_prev,
            opt_constr=c.opt_constr,
            mu=c.mu,
            reg=c.reg,
            step=c.step,
            converged=torch.tensor(c.done, device=device),
        ),
        history=hist,
    )
